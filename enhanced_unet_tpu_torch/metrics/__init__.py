"""Metrics of the PyTorch port: semantic IoU and Dice from confusion
matrices built on the device (`metrics.semantic`)."""
