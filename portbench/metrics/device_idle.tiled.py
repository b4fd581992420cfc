"""`device_idle.tiled` in the tiled cell: `traceread.device_idle`."""

from portbench.traceread import device_idle as read  # noqa: F401
