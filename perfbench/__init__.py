"""The benchmark of the PyTorch/CUDA port (``ccx_torch``): cells of
``BENCHMARK.json`` served through the port's gRPC sidecar on one card and
judged against the plain NumPy reference in ``perfbench/reference/``.
Run ``python3 -m perfbench.run --help`` from the repository root."""
