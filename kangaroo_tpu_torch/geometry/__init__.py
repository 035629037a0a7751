"""Geometry: depth images to point and normal images, and heightmap fusion."""
from . import depth, heightmap
