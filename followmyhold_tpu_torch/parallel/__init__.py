"""Device mesh and sharding (dp over images, tp over transformer weights)."""

from followmyhold_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    parse_mesh_shape,
    replicate,
    shard_model_params,
)

__all__ = ["parse_mesh_shape", "make_mesh", "batch_sharding", "replicate",
           "shard_model_params"]
