"""Geometry: depth images to point and normal images."""
from . import depth
