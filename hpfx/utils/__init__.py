from .precision import highest_precision
from .profiling import debug_nans, profile_trace
from .timing import PhaseTimer

__all__ = [
    "highest_precision",
    "PhaseTimer",
    "debug_nans",
    "profile_trace",
]
