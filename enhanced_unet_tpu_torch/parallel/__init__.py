"""Parallelism over devices, ported from `enhanced_unet_tpu/parallel/`: the
1-D axis of processes (`make_mesh`: one process per device, NCCL on the
cards, gloo on the CPU), the data-parallel train step and its helpers,
tiled inference with the tiles split over the axis, spatial
partitioning (`spatial.py`: each rank a band of rows of one image, the
halos exchanged at every stencil, any model of `get_model`) and tensor
parallelism (`tensor_parallel.py`: a grid of data x model ranks, the wide
conv weights split on their output or input channels over the model axis;
its forward and its train step).  `spawn` starts one worker process per rank.
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
from enhanced_unet_tpu_torch.parallel.tensor_parallel import (
    Mesh2D,
    make_mesh_2d,
    make_tp_apply,
    make_tp_train_step,
    shard_params_tp,
    tp_param_specs,
)
from enhanced_unet_tpu_torch.parallel.tiled import map_tiles_sharded, tiled_inference_sharded

__all__ = ["Mesh", "Mesh2D", "gather_image_h", "halo_exchange", "make_mesh",
           "make_mesh_2d", "make_dp_train_step", "map_tiles_sharded", "make_spatial_apply",
           "make_spatial_basic_unet", "make_spatial_conv3x3", "make_tp_apply",
           "make_tp_train_step",
           "replica_seed", "replicate_state", "shard_batch", "shard_image_h",
           "shard_params_tp", "spawn", "tiled_inference_sharded", "tp_param_specs"]
