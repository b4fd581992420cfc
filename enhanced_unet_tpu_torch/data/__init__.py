"""Data helpers of the PyTorch port: the COCO run-length codec
(`data.rle`).  The dataset and loader are not ported yet."""

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

__all__ = ["encode_rle", "decode_rle", "mask_to_bbox", "rle_area", "rle_iou",
           "rle_to_bbox", "rle_to_string", "rle_from_string"]
