"""TSDF fusion and raycasting: the exact and guided engines (voxel fuse and
sphere trace), the plane-sweep (separable) engine with its fuse kernel, and
the rolling workspace."""
from . import raycast, rolling, sdf, separable
