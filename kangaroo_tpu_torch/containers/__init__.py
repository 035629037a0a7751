"""Containers: bounding boxes, pinhole intrinsics, bounded and TSDF volumes,
pyramids."""
from . import bbox, intrinsics, pyramid, volume
from .bbox import BoundingBox, fit_to_frustum
from .intrinsics import Intrinsics, level_from_max_pixels
from .volume import BoundedVolume, TsdfVolume
