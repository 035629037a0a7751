"""Geometry: depth images to point and normal images, heightmap fusion, pose
graphs and scanline rectification."""
from . import depth, heightmap, pose_graph, rectify
