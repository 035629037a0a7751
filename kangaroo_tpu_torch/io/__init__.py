"""Host-side IO: PXM images, volumes and depth maps, the threaded frame
loader, camera rig files and streaming tracker-pose input."""
from . import frame_loader, pxm, rig, tracker
