from rtdm_tpu_torch.parallel.comms import (
    all_gather_along,
    broadcast_from,
    pmean_grads,
    psum_along,
    shard_batch,
)
from rtdm_tpu_torch.parallel.shard import (
    make_shard_map_train_step,
    spatial_shard_conv,
)

__all__ = [
    "all_gather_along",
    "broadcast_from",
    "pmean_grads",
    "psum_along",
    "shard_batch",
    "make_shard_map_train_step",
    "spatial_shard_conv",
]
