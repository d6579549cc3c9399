"""``python -m ccx_torch.bench --ladder/--scaling/--mesh`` against the JAX
bench (``bench.py``'s ladder in ``main``, ``run_config``, ``run_scaling``,
``run_mesh_bench``): the rung list, the sidecar rule, the rungs' options
under the bench's environment knobs, and small runs on the CPU whose lines
carry the banked lines' keys (``BENCH_r05.json``, ``MULTICHIP_r06.json``)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

import bench
from ccx_torch import rungs
from ccx_torch.bench import ladder
from ccx_torch.model.fixtures import RandomClusterSpec

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("CCX_BENCH_CHAINS", "CCX_BENCH_STEPS", "CCX_BENCH_MOVES", "CCX_BENCH_POLISH_ITERS")
#: keys of the JAX bench's ladder line the port leaves out on purpose
#: (``ccx_torch/bench/ladder.py`` docstring): the MXU probe, the prewarm
#: pass and the CPU fallback's reason
JAX_ONLY = {"mxu_ab", "prewarm", "backend_detail"}
TINY = RandomClusterSpec(n_brokers=8, n_racks=2, n_topics=4, n_partitions=64, seed=1)
SMALL = RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=4, n_partitions=256, seed=1)


@pytest.fixture
def clean_env(monkeypatch):
    for var in (*KNOBS, "CCX_BENCH_SIDECAR", "CCX_BENCH_SHARDED", "CCX_BENCH_SHARDED_PARTS",
                "CCX_BENCH_PORTFOLIO", "CCX_BENCH_SKIP_SMOKE", "CCX_BENCH_CHUNK",
                "CCX_BENCH_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _jax_rungs(name: str) -> list[str]:
    """The rung list of ``bench.py``'s ``main`` on the card (no CPU cut)."""
    import os

    rungs_ = ["lean", "full"]
    if name == "B5":
        rungs_ = ["target"] + rungs_
    if all(os.environ.get(k) for k in KNOBS):
        rungs_ = ["custom"]
    return rungs_


@pytest.mark.parametrize("knobs", [0, 3, 4])
@pytest.mark.parametrize("name", ["B1", "B3", "B5"])
def test_rung_list(name, knobs, clean_env):
    for var in KNOBS[:knobs]:
        clean_env.setenv(var, "2")
    assert ladder.ladder_rungs(name) == _jax_rungs(name)
    if knobs == 4:
        assert ladder.ladder_rungs(name) == ["custom"]
    elif name == "B5":
        assert ladder.ladder_rungs(name) == ["target", "lean", "full"]
    else:
        assert ladder.ladder_rungs(name) == ["lean", "full"]


@pytest.mark.parametrize("value", [None, "", "0", "1"])
@pytest.mark.parametrize("rung", ["target", "lean", "full"])
def test_sidecar_rule_is_the_benchs(rung, value, clean_env):
    if value is not None:
        clean_env.setenv("CCX_BENCH_SIDECAR", value)
    assert ladder.sidecar_for_rung(rung) == bench._sidecar_for_rung(rung)


def test_sidecar_rule_refuses_other_values(clean_env):
    clean_env.setenv("CCX_BENCH_SIDECAR", "yes")
    with pytest.raises(SystemExit, match="CCX_BENCH_SIDECAR"):
        ladder.sidecar_for_rung("target")
    with pytest.raises(SystemExit, match="CCX_BENCH_SIDECAR"):
        bench._sidecar_for_rung("target")


@pytest.mark.parametrize("rung", ["smoke", "target", "lean", "full", "custom"])
def test_rung_options_under_the_benchs_knobs(rung, clean_env):
    """The effort knobs, the portfolio switch and ``CCX_BENCH_SHARDED``
    reach the options as ``bench.build_opts`` sends them, never at the
    smoke rung."""
    for var, val in zip(KNOBS, ("4", "60", "2", "30")):
        clean_env.setenv(var, val)
    clean_env.setenv("CCX_BENCH_SHARDED", "1")
    clean_env.setenv("CCX_BENCH_SHARDED_PARTS", "2")
    clean_env.setenv("CCX_BENCH_PORTFOLIO", "0")
    _, opts, effort = rungs.build_opts("B5", rung)
    _, jopts, jeffort = bench.build_opts("B5", rung)
    for f in ("mesh_enabled", "mesh_devices", "mesh_parts", "run_cold_greedy"):
        assert getattr(opts, f) == getattr(jopts, f), f
    for f in ("n_chains", "n_steps", "moves_per_step", "chunk_steps"):
        assert getattr(opts.anneal, f) == getattr(jopts.anneal, f), f
    assert opts.polish.max_iters == jopts.polish.max_iters
    assert opts.mesh_enabled == (rung != "smoke")
    for key in ("chains", "steps", "moves", "polish_iters", "portfolio"):
        assert effort[key] == jeffort[key], key
    assert effort.get("mesh") == jeffort.get("mesh")


def test_ladder_lines_on_the_cpu(clean_env):
    """The smoke rung and one custom rung at tiny knobs, in process: every
    line carries ``LINE_KEYS`` and the banked line's keys, verifies, and the
    warm runs build nothing."""
    for var, val in zip(KNOBS, ("2", "4", "2", "3")):
        clean_env.setenv(var, val)
    clean_env.setenv("CCX_BENCH_SIDECAR", "0")
    lines = []
    out = ladder.run_ladder("B1", device="cpu", spec=TINY, smoke_spec=TINY, emit=lines.append)
    assert out == lines and [ln["rung"] for ln in lines] == ["smoke", "custom"]
    banked = set(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])
    for ln in lines:
        assert set(ladder.LINE_KEYS) <= set(ln)
        assert banked - JAX_ONLY <= set(ln)
        assert ln["verified"], ln["verification_failures"]
        assert ln["backend"] == "cpu" and ln["unit"] == "s"
        assert ln["vs_baseline"] == pytest.approx(ladder.TARGET_S / ln["value"], rel=1e-2)
        assert ln["compile_cache"]["warm"]["backend_compiles"] == 0
        assert ln["samples"]["n"] == 1 and ln["mesh"] is None
        json.dumps(ln)
    assert lines[0]["goals"] == {} and lines[1]["goals"]
    assert lines[1]["effort"]["chains"] == 2 and lines[1]["effort"]["steps"] == 4


def test_ladder_over_the_wire_and_sharded(clean_env):
    """A custom rung through the sidecar (a put, then a Propose a run), and
    one in process under ``CCX_BENCH_SHARDED=1`` on the virtual mesh."""
    for var, val in zip(KNOBS, ("2", "4", "2", "3")):
        clean_env.setenv(var, val)
    clean_env.setenv("CCX_BENCH_SKIP_SMOKE", "1")
    clean_env.setenv("CCX_BENCH_SIDECAR", "1")
    wire = ladder.run_ladder("B1", device="cpu", spec=TINY, emit=lambda _: None)[-1]
    assert wire["verified"] and wire["sidecar"]["put_s"] >= 0
    assert "hop_overhead_cold_s" in wire["sidecar"] and "hop_overhead_warm_s" in wire["sidecar"]
    clean_env.setenv("CCX_BENCH_SIDECAR", "0")
    clean_env.setenv("CCX_BENCH_SHARDED", "1")
    clean_env.setenv("CCX_BENCH_SHARDED_PARTS", "2")
    sharded = ladder.run_ladder("B1", device="cpu", spec=TINY, emit=lambda _: None)[-1]
    assert sharded["verified"]
    assert sharded["mesh"]["meshShape"] == {"chains": 4, "parts": 2}
    assert sharded["mesh"]["virtual"] is True
    assert sharded["effort"]["mesh"] == ["all", 2]


def test_scaling_line_on_the_cpu(clean_env):
    clean_env.setenv("CCX_BENCH_CHAINS", "4")
    clean_env.setenv("CCX_BENCH_STEPS", "4")
    clean_env.setenv("CCX_BENCH_MOVES", "2")
    clean_env.setenv("CCX_BENCH_CHUNK", "2")
    out = ladder.run_scaling("B2", device="cpu", spec=SMALL, n_devices=4)
    banked = set(json.loads((ROOT / "MULTICHIP_r06.json").read_text()))
    assert banked <= set(out)
    assert out["verified"] and out["scaling"] and out["backend"] == "cpu"
    assert out["mesh"] == {"devices": 4, "virtual": True}
    assert [row["devices"] for row in out["curve"]] == [1, 2, 4]
    assert list(out["curve"][-1]["layouts"]) == ["4x1", "2x2", "1x4"]
    assert ladder.scaling_layouts(8) == bench._scaling_layouts(8)
    assert set(out["speedup_vs_1dev"]) == {"1", "2", "4"}


def test_mesh_line_on_the_cpu(clean_env):
    out = ladder.run_mesh_bench("B2", device="cpu", spec=SMALL, n_devices=2, steps=(2, 4))
    assert out["verified"] and out["unit"] == "ms/step" and out["n_devices"] == 2
    assert out["mesh"] == {"chains": 1, "parts": 2, "devices": 2, "virtual": True}
    for key in ("metric", "value", "vs_baseline", "unsharded_ms_per_step", "backend"):
        assert key in out
    assert set(out["walls"]["sharded"]) == {2, 4}


def test_the_entry_point_runs_the_ladder(clean_env, capsys):
    from ccx_torch.bench.__main__ import main

    for var, val in zip(KNOBS, ("2", "4", "2", "3")):
        clean_env.setenv(var, val)
    clean_env.setenv("CCX_BENCH_SKIP_SMOKE", "1")
    clean_env.setenv("CCX_BENCH_SIDECAR", "0")
    assert main(["--ladder", "B1", "--device", "cpu"]) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["rung"] for ln in printed] == ["custom", "custom"]
    assert printed[0] == printed[1] and printed[0]["verified"]


def test_line_keys_cover_the_benchs_optional_keys():
    """Every key ``bench.py``'s ladder line may carry is in ``LINE_KEYS``
    or named as left out."""
    src = (ROOT / "bench.py").read_text()
    start = src.index("for rung in rungs:\n        r = run_config(name, rung, samples=samples)")
    block = src[start:src.index('_state["done"] = True', start)]
    import re

    keys = set(re.findall(r'\{?\s*"([a-zA-Z_]+)":', block)) - {"n", "min", "median", "max"}
    assert keys - JAX_ONLY <= set(ladder.LINE_KEYS), keys - JAX_ONLY - set(ladder.LINE_KEYS)
    assert dataclasses.is_dataclass(rungs.OptimizeOptions)
