"""Tensor operations of the PyTorch port: resizes, preprocessing, TTA, the
threshold cascade, and the hand-written CUDA kernels under `kernels/`."""
