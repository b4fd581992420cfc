"""`peak_mem_gib.tiled` in the tiled cell: `traceread.peak_mem_gib`."""

from portbench.traceread import peak_mem_gib as read  # noqa: F401
