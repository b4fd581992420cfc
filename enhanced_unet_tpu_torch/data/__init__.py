"""Data layer of the PyTorch port: the host-side dataset (decode, labelme
polygons, deterministic split, fixed-shape batching), the batch loader
whose device half runs the preprocess and augmentation, and the COCO
run-length codec."""

from enhanced_unet_tpu_torch.data.rle import (
    decode_rle,
    encode_rle,
    mask_to_bbox,
    rle_area,
    rle_from_string,
    rle_iou,
    rle_to_bbox,
    rle_to_string,
)
from enhanced_unet_tpu_torch.data.dataset import CellDataset, collate_fn
from enhanced_unet_tpu_torch.data.loader import BatchLoader

__all__ = ["BatchLoader", "CellDataset", "collate_fn", "encode_rle", "decode_rle",
           "mask_to_bbox", "rle_area", "rle_iou", "rle_to_bbox", "rle_to_string",
           "rle_from_string"]
