"""`head_ms.segformer` in the SegFormer cell: `tokenread.head_ms`."""

from portbench.tokenread import head_ms as read  # noqa: F401
