"""Distributed SpTTN on ``torch.distributed`` (the JAX package's
``repro.distributed``).

The reference's names and their counterparts here:
``make_distributed`` -> ``make_distributed``;
``make_distributed_pallas`` -> ``make_distributed_cuda``;
``make_distributed_tuned`` -> ``make_distributed_tuned``;
``DistributedPlanReplay`` -> ``DistributedPlanReplay``;
``DIST_MODES`` -> ``DIST_MODES`` ("collective-pallas" -> "collective-cuda");
``partition_mesh`` -> ``partition_mesh``;
``partition_nonzeros`` -> ``partition_nonzeros``;
``shard_mesh_key`` -> ``shard_mesh_key``;
``stackable_plan`` -> ``stackable_plan``;
``unpad_local_csf`` -> ``unpad_local_csf``;
modules ``collectives`` -> ``collectives``, ``spttn_dist`` -> ``spttn_dist``,
``sharding`` -> ``sharding`` (the rules and ``tree_sharding`` as DTensor
placements, ``mesh_context``, and the gathered-weights sharded step's
gather and batch split).
"""
from repro_torch.distributed import collectives, sharding, spttn_dist
from repro_torch.distributed.spttn_dist import (DIST_MODES,
                                                DistributedPlanReplay,
                                                make_distributed,
                                                make_distributed_cuda,
                                                make_distributed_tuned,
                                                partition_mesh,
                                                partition_nonzeros,
                                                shard_mesh_key,
                                                stackable_plan,
                                                unpad_local_csf)

__all__ = [
    "collectives", "sharding", "spttn_dist", "DIST_MODES",
    "DistributedPlanReplay",
    "make_distributed", "make_distributed_cuda", "make_distributed_tuned",
    "partition_mesh", "partition_nonzeros", "shard_mesh_key",
    "stackable_plan", "unpad_local_csf",
]
