"""TSDF fusion and raycasting: the exact and guided engines (voxel fuse and
sphere trace), the plane-sweep (separable) engine with its fuse kernel, the
rolling workspace, and mesh extraction on the host."""
from . import marching_cubes, marching_cubes256, raycast, rolling, sdf, separable
