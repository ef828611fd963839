from mrisr_torch.parallel.mesh import (
    average_gradients,
    batch_sharding,
    make_mesh,
    make_mesh_2d,
    replicate_params,
    replicated,
    shard_batch,
    shard_params_tp,
    tp_param_sharding,
)

__all__ = ["make_mesh", "make_mesh_2d", "batch_sharding", "replicated", "replicate_params", "shard_batch",
           "average_gradients", "tp_param_sharding", "shard_params_tp"]
