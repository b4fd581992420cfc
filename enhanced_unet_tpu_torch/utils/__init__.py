"""Utilities of the PyTorch port: step timing, profiler traces and debug
toggles."""

from enhanced_unet_tpu_torch.utils.profiler import StepTimer, enable_debug, trace_context

__all__ = ["StepTimer", "trace_context", "enable_debug"]
