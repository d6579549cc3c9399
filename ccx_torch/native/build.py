"""Build the native kernels: ``python -m ccx_torch.native.build`` (into
``ccx_torch/_build/native/``)."""

from __future__ import annotations

import os
import subprocess
import sys


def build(quiet: bool = False) -> str:
    src_dir = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(os.path.dirname(src_dir), "_build", "native")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libccxnative.so")
    src = os.path.join(src_dir, "aggregate.cpp")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = out + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        src, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=quiet)
    os.replace(tmp, out)  # atomic: concurrent builders never tear the .so
    if not quiet:
        print(f"built {out}")
    return out


if __name__ == "__main__":
    sys.exit(0 if build() else 1)
