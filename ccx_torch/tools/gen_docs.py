"""Documentation generator: the config and REST references from the port's
own definitions (``ccx_torch/config/configs.py``,
``ccx_torch/servlet/endpoints.py``), in the JAX package's format.

    python -m ccx_torch.tools.gen_docs OUT_DIR

writes ``OUT_DIR/Configurations.md`` and ``OUT_DIR/REST-API.md``. The
output directory has no default, so the JAX package's ``docs/wiki/`` is
never overwritten.
"""

from __future__ import annotations

import argparse
import os

from ccx_torch.config.configs import cruise_control_config_def
from ccx_torch.servlet.endpoints import (
    GET_ENDPOINTS,
    PARAMETERS,
    EndPoint,
)


def gen_config_reference() -> str:
    rows = cruise_control_config_def().doc_table()
    out = [
        "# Configurations",
        "",
        "Generated from `ccx_torch/config/configs.py` (do not edit by hand; run "
        "`python -m ccx_torch.tools.gen_docs`). Key names follow the reference's "
        "`cruisecontrol.properties` vocabulary.",
        "",
        "| Name | Type | Default | Importance | Description |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        default = r["default"]
        if isinstance(default, tuple):
            default = ",".join(str(x) for x in default) or "(empty)"
        default = "" if default is None else str(default)
        if len(default) > 60:
            default = default[:57] + "..."
        out.append(
            f"| `{r['name']}` | {r['type']} | {default or '—'} "
            f"| {r['importance']} | {r['doc']} |"
        )
    return "\n".join(out) + "\n"


def gen_rest_reference() -> str:
    out = [
        "# REST API",
        "",
        "Generated from `ccx_torch/servlet/endpoints.py`. All endpoints live under "
        "`/kafkacruisecontrol/<endpoint>` and return JSON. Requests that "
        "exceed `webserver.request.maxBlockTimeMs` return **202** with a "
        "`User-Task-ID` header — repeat the request with that header (or "
        "poll `user_tasks`) until **200**. With "
        "`two.step.verification.enabled`, non-dryrun mutating POSTs park in "
        "the purgatory and must be approved via `review`, then re-submitted "
        "with `review_id`.",
        "",
    ]
    for ep in EndPoint:
        method = "GET" if ep in GET_ENDPOINTS else "POST"
        out.append(f"## {method} `/kafkacruisecontrol/{ep.value}`")
        out.append("")
        out.append("| Parameter | Type | Default |")
        out.append("|---|---|---|")
        for spec in PARAMETERS[ep]:
            default = spec.default
            if isinstance(default, tuple):
                default = ",".join(map(str, default)) or "(empty)"
            out.append(
                f"| `{spec.name}` | {spec.type.value} "
                f"| {default if default is not None else '—'} |"
            )
        out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ccx_torch.tools.gen_docs",
                                 description="write the config and REST references")
    ap.add_argument("out_dir", help="directory to write Configurations.md and REST-API.md into")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "Configurations.md"), "w") as f:
        f.write(gen_config_reference())
    with open(os.path.join(args.out_dir, "REST-API.md"), "w") as f:
        f.write(gen_rest_reference())
    print(f"wrote {args.out_dir}/Configurations.md and {args.out_dir}/REST-API.md")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
