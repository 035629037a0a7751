"""Host-side IO: the PXM image, volume and depth-map files."""
from . import pxm
