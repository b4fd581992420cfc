"""PyTorch/CUDA port of the Enhanced-UNet system for NVIDIA Hopper.

The JAX package `enhanced_unet_tpu` is the reference; this package imports
nothing of it and nothing of JAX.  Public functions keep the JAX package's
layouts (NHWC images, `model(x_nhwc) -> (logits_nhwc_f32, aux)`), so the
two packages can be held against each other on the same inputs.
"""

__all__ = ["config", "device", "models", "ops", "train", "convert", "data", "metrics",
           "postprocess", "native", "viz", "utils"]
