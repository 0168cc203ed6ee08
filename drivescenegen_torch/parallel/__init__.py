from drivescenegen_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean_,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
