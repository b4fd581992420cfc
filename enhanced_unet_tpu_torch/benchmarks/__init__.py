"""Kernel benches of the MBConv block and the depthwise convolution, the
port's counterparts of the root `benchmarks/pallas_*` scripts.  Each module
runs on the CUDA card with `python -m enhanced_unet_tpu_torch.benchmarks.<name>`
and prints one JSON object per row."""
