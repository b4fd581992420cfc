"""`k2_roofline.tiled` in the tiled cell: `traceread.k2_roofline`."""

from portbench.traceread import k2_roofline as read  # noqa: F401
