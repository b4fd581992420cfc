"""`program_idle_ms.tiled` in the tiled cell: `spanread.program_idle_ms`."""

from portbench.spanread import program_idle_ms as read  # noqa: F401
