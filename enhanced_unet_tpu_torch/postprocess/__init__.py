"""Host-side post-processing of the PyTorch port: semantic mask ->
instances (numpy and scipy; OpenCV's semantics without OpenCV)."""

from enhanced_unet_tpu_torch.postprocess.instances import semantic_to_instances

__all__ = ["semantic_to_instances"]
