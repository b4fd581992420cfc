"""Parallelism over devices, ported from `enhanced_unet_tpu/parallel/`: the
1-D axis of processes (`make_mesh`: one process per device, NCCL on the
cards, gloo on the CPU), the data-parallel train step and its helpers,
tiled inference with the tiles split over the axis, and spatial
partitioning (`spatial.py`: each rank a band of rows of one image, the
halos exchanged at every stencil, any model of `get_model`).  `spawn`
starts one worker process per rank.

Not ported yet: `tensor_parallel.py` (column/row splits of the conv weights
over a second axis).
"""

from enhanced_unet_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    replica_seed,
    replicate_state,
    shard_batch,
    spawn,
)
from enhanced_unet_tpu_torch.parallel.mesh import Mesh, make_mesh
from enhanced_unet_tpu_torch.parallel.spatial import (
    gather_image_h,
    halo_exchange,
    make_spatial_apply,
    make_spatial_basic_unet,
    make_spatial_conv3x3,
    shard_image_h,
)
from enhanced_unet_tpu_torch.parallel.tiled import tiled_inference_sharded

__all__ = ["Mesh", "gather_image_h", "halo_exchange", "make_mesh",
           "make_dp_train_step", "make_spatial_apply", "make_spatial_basic_unet",
           "make_spatial_conv3x3", "replica_seed", "replicate_state", "shard_batch",
           "shard_image_h", "spawn", "tiled_inference_sharded"]
