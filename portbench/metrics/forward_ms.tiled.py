"""`forward_ms.tiled` in the tiled cell: `spanread.forward_ms`."""

from portbench.spanread import forward_ms as read  # noqa: F401
