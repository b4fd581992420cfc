"""`pipeline_ms.tiled` in the tiled cell: `spanread.pipeline_ms`."""

from portbench.spanread import pipeline_ms as read  # noqa: F401
