"""Data-parallel training over a ``torch.distributed`` process group
(port of ``srm_tpu/parallel``)."""

from srm_tpu_torch.parallel.mesh import (Mesh, make_mesh, pad_to_multiple,
                                         process_group_from_env, rank_device, rank_zero_first,
                                         replicate, shard_batch)

__all__ = ["Mesh", "make_mesh", "pad_to_multiple", "process_group_from_env", "rank_device",
           "rank_zero_first", "replicate", "shard_batch"]
