"""Utilities: timing, profiling, the NaN debug modes and sorting networks."""
from . import profiling, timing
