"""ccx_torch — the cluster-rebalancing optimizer in PyTorch, for CUDA.

A port of the ``ccx`` package (JAX) that keeps its layouts and dtypes at
every public function. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; with no card present and no explicit device they
raise (``ccx_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
