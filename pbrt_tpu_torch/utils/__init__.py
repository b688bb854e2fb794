"""Runtime utilities: stats, progress, display streaming, profiling.

Port of pbrt_tpu/utils (reference analogue: pbrt-v4
src/pbrt/util/{stats,progressreporter,display}.*).
"""

from .stats import STATS, ProgressReporter, stat_counter  # noqa: F401
