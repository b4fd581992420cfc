"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter.

A wrapper runs the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches its kernel or raises; nothing falls back.
"""

KERNEL_SOURCES = ("conv3x3_bn_act", "mbconv", "mbconv_nhwc", "mbconv_nhwc_expand",
                  "depthwise", "copy", "scse")
