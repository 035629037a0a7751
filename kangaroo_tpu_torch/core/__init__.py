"""Core helpers: invalid-value sentinels, SE3 algebra, image sampling,
IRLS weights."""
from . import invalid, reweighting, sampling, se3
