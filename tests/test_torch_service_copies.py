"""The service layer's copies of JAX-free modules stay equal to their
originals.

``ccx_torch`` imports nothing of ``ccx``, so the service layer carries its
own copy of every JAX-free module it needs. Each copy must equal its JAX
original once the ``ccx`` import roots and the ``"ccx.`` class paths are
rewritten to ``ccx_torch``. The few copies with further edits name the
regions of the original that may differ, and why; the rest of such a file
must still be equal. A second test makes sure the list covers every module
of the service layer's packages that the façade, the REST app and ``main``
load.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: paths under ``ccx/`` copied to the same path under ``ccx_torch/``
COPIES = (
    "common/exceptions.py", "common/metadata.py", "common/slo.py",
    "config/__init__.py", "config/definition.py", "config/configs.py",
    "native/__init__.py", "native/build.py", "native/aggregate.cpp",
    "monitor/__init__.py", "monitor/metricdef.py", "monitor/capacity.py",
    "monitor/model_utils.py", "monitor/aggregator.py",
    "monitor/sampling/__init__.py", "monitor/sampling/holders.py",
    "monitor/sampling/sampler.py", "monitor/sampling/sample_store.py",
    "monitor/sampling/prometheus_sampler.py", "monitor/sampling/reporter_sampler.py",
    "reporter/__init__.py", "reporter/metrics.py", "reporter/transport.py",
    "reporter/reporter.py",
    "executor/__init__.py", "executor/admin.py", "executor/execution_task.py",
    "executor/strategy.py", "executor/task_manager.py", "executor/executor.py",
    "executor/kafka_admin.py",
    "detector/__init__.py", "detector/anomalies.py", "detector/notifier.py",
    "detector/provisioner.py", "detector/slow_broker.py", "detector/detectors.py",
    "detector/stream.py", "detector/manager.py",
    "service/__init__.py", "service/async_ops.py",
    "servlet/__init__.py", "servlet/endpoints.py", "servlet/purgatory.py",
    "servlet/security.py", "servlet/ui.py", "servlet/openapi.py",
    "servlet/openapi_server.py", "servlet/server.py",
    "client/__init__.py", "client/__main__.py", "client/client.py", "client/cli.py",
)

#: the service layer's modules that are ports, not copies (they reach the
#: port's tensor model, optimizer or device)
PORTS = ("monitor/load_monitor.py", "service/facade.py")

#: copies with further edits: each region of the original that may differ,
#: from the first line holding its first anchor to the next line holding its
#: second, and the reason
EDITED = {
    "config/definition.py": (
        [("def resolve_class", "try:")],
        "a class path under ccx resolves under ccx_torch, so properties "
        "files written for the JAX package never load it",
    ),
    "config/configs.py": (
        [('"optimizer.chunk.steps"', "at_least(0))"),
         ('"optimizer.mesh.enabled"', "visible.\")"),
         ('"optimizer.polish.chunk.iters"', "ran >17 min"),
         ('"optimizer.plan.enabled"', "Movement planning (ccx.search.movement"),
         ('"optimizer.profile.dir"', "proposal-computation-timer).\")"),
         ('"observability.cost.peak.tflops"', "at_least(0))")],
        "texts that named TPU times or parts, a JAX mesh or jax.profiler, "
        "or the JAX package's change history; every key, default, type and "
        "validator is unchanged",
    ),
    "native/__init__.py": (
        [("Build with ``python -m", "numpy fallback)."),
         ("_load_lock = ", 'return os.path.join(os.path.dirname(__file__), "_build"'),
         ("def available()", "return load() is not None"),
         ("def scatter(", "return True")],
        "the library builds into ccx_torch/_build/native/, and state() "
        "counts which path the scatters took",
    ),
    "native/build.py": (
        [('"""Build the native kernels', '"""Build the native kernels'),
         ("out_dir = ", "out_dir = ")],
        "the library builds into ccx_torch/_build/native/",
    ),
    "executor/executor.py": (
        [("# measured per-wave completion telemetry (", "): real MB/s from finished"),
         ("# measured completion telemetry (", "# measured completion telemetry (")],
        "comments cited the JAX package's change history",
    ),
    "detector/manager.py": (
        [("# the live-stream detector (", "# the live-stream detector ("),
         ("# ----- the live-stream loop (", "# ----- the live-stream loop ("),
         ("stream-detector + SLO summary (", "stream-detector + SLO summary (")],
        "comments cited the JAX package's change history",
    ),
}

#: the packages of the service layer, under ``ccx_torch``
SERVICE_PACKAGES = ("config", "native", "monitor", "reporter", "executor", "detector",
                    "service", "servlet", "client")


def rewrite(text: str) -> str:
    """The JAX original as the port's copy: ``ccx`` import roots and
    ``"ccx.`` class paths under ``ccx_torch``."""
    text = re.sub(r"^(\s*)from ccx([. ])", r"\1from ccx_torch\2", text, flags=re.M)
    text = re.sub(r"^(\s*)import ccx\b", r"\1import ccx_torch", text, flags=re.M)
    return text.replace('"ccx.', '"ccx_torch.')


def _allowed(lines: list[str], spans) -> set[int]:
    allowed: set[int] = set()
    for first, last in spans:
        i = next(k for k, ln in enumerate(lines) if first in ln)
        j = next(k for k in range(i, len(lines)) if last in lines[k])
        allowed.update(range(i, j + 1))
    return allowed


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_jax_original(rel):
    original = (ROOT / "ccx" / rel).read_text()
    copy = (ROOT / "ccx_torch" / rel).read_text()
    if not rel.endswith(".py"):
        assert copy == original
        return
    want = rewrite(original)
    if rel not in EDITED:
        assert copy == want, f"ccx_torch/{rel} drifted from ccx/{rel}"
        return
    a, b = want.splitlines(), copy.splitlines()
    spans, _reason = EDITED[rel]
    allowed = _allowed(a, spans)
    opcodes = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in opcodes:
        if tag == "equal":
            continue
        if i2 > i1:
            inside = all(k in allowed for k in range(i1, i2))
        else:  # an insertion: next to a region, blank lines aside
            k = i1 - 1
            while k >= 0 and not a[k].strip():
                k -= 1
            inside = k in allowed or i1 in allowed
        assert inside, (
            f"ccx_torch/{rel} differs outside its named regions at line {i1 + 1}: "
            f"{a[i1:i2][:3]} -> {b[j1:j2][:3]}")
    assert any(tag != "equal" for tag, *_ in opcodes), f"{rel} is listed as edited but is not"


def test_copies_cover_every_service_module_the_entry_points_load():
    """Importing the façade, the REST app and ``main`` in a fresh
    interpreter: every module of the service layer's packages it loads is a
    copy listed here or one of the ported modules."""
    code = (
        "import sys\n"
        "import ccx_torch.main, ccx_torch.service.facade, ccx_torch.servlet.server\n"
        "import ccx_torch.client.cli\n"
        "print('\\n'.join(sorted(m.__file__ for n, m in sys.modules.items()\n"
        "      if n.startswith('ccx_torch.') and getattr(m, '__file__', None))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120,
                         capture_output=True, text=True).stdout.split()
    loaded = {str(Path(f).relative_to(ROOT / "ccx_torch")) for f in out}
    service = {m for m in loaded if m.split("/")[0] in SERVICE_PACKAGES
               or m in ("common/exceptions.py", "common/metadata.py", "common/slo.py")}
    unlisted = service - set(COPIES) - set(PORTS)
    assert not unlisted, f"service modules neither copied nor ported: {sorted(unlisted)}"
    assert set(PORTS) <= loaded
    assert {"service/facade.py", "servlet/server.py", "detector/manager.py"} <= service
