"""`tiled_mfu` in the tiled cell: `traceread.mfu`."""

from portbench.traceread import mfu as read  # noqa: F401
