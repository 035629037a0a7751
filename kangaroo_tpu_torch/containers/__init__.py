"""Containers: bounding boxes, pinhole intrinsics, TSDF volumes, pyramids."""
from . import bbox, intrinsics, pyramid, volume
from .bbox import BoundingBox
from .intrinsics import Intrinsics
from .volume import TsdfVolume
