"""`attention_roofline.segformer` in the SegFormer cell: `tokenread.attention_roofline`."""

from portbench.tokenread import attention_roofline as read  # noqa: F401
