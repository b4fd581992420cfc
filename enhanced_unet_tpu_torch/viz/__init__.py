"""Reports of the PyTorch port: the reference's matplotlib chart suite on
host numpy arrays (`Visualizer`).  Importing it loads no matplotlib; the
first `Visualizer` does."""

from enhanced_unet_tpu_torch.viz.visualizer import Visualizer

__all__ = ["Visualizer"]
