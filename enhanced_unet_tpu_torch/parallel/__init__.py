"""Parallelism over devices, ported from `enhanced_unet_tpu/parallel/`: the
1-D data axis (`make_mesh`: one process per device, NCCL on the cards,
gloo on the CPU), the data-parallel train step and its helpers, and tiled
inference with the tiles split over the axis.  `spawn` starts one worker
process per rank.

Not ported yet: `spatial.py` (spatial partitioning, which needs a
hand-written halo exchange at every stencil) and `tensor_parallel.py`
(column/row splits of the conv weights over a second axis).
"""

from enhanced_unet_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    replica_seed,
    replicate_state,
    shard_batch,
    spawn,
)
from enhanced_unet_tpu_torch.parallel.mesh import Mesh, make_mesh
from enhanced_unet_tpu_torch.parallel.tiled import tiled_inference_sharded

__all__ = ["Mesh", "make_mesh", "make_dp_train_step", "replica_seed", "replicate_state",
           "shard_batch", "spawn", "tiled_inference_sharded"]
