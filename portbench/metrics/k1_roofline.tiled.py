"""`k1_roofline.tiled` in the tiled cell: `traceread.k1_roofline`."""

from portbench.traceread import k1_roofline as read  # noqa: F401
