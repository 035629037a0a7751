"""TSDF fusion and raycasting: the exact sphere trace and the plane-sweep
(separable) engine with its fuse kernel."""
