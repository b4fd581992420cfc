"""`dw_gelu_roofline.segformer` in the SegFormer cell: `tokenread.dw_gelu_roofline`."""

from portbench.tokenread import dw_gelu_roofline as read  # noqa: F401
