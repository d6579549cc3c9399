"""Device-mesh sharding (``ccx_torch.parallel.sharding``)."""

from ccx_torch.parallel.sharding import (
    make_mesh,
    model_pspecs,
    replicate,
    shard_model,
    sharded_anneal,
    sharded_stack_eval,
)

__all__ = [
    "make_mesh",
    "model_pspecs",
    "replicate",
    "shard_model",
    "sharded_anneal",
    "sharded_stack_eval",
]
