"""Core helpers: invalid-value sentinels."""
from . import invalid
