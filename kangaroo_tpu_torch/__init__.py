"""kangaroo_tpu_torch — the dense-vision framework in PyTorch with CUDA kernels.

A port of ``kangaroo_tpu`` (JAX/XLA/Pallas) to PyTorch for NVIDIA Hopper
(sm_90a). Module paths mirror the JAX package: ``stereo.census`` here is
``kangaroo_tpu.stereo.census`` there. Plain code is PyTorch; each Pallas
kernel of the ported slice is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` at first use (``_build``). For a tensor on
the CPU every op runs its plain PyTorch version; for a CUDA tensor it
launches the kernel or raises.

Ported so far: the SGM stereo frame (``apps.stereo_sgm.sgm_pipeline``, on
one device or over a device mesh of ``parallel``) and its stacked batch
(``sgm_pipeline_batched``), DTAM variational stereo (``apps.stereo``), the
variational solvers (``variational``), the KinectFusion frame on its
three engines, with colour fusion and the moving workspace
(``apps.kinectfusion``), its output side (meshes built on the host by
``fusion.marching_cubes``, volume files, keyframe texturing), and the
photometric, calibration and Manhattan solvers (``solvers``), scanline
rectification and the pose graph (``geometry``); the host side: the
threaded frame loader, rig and tracker files (``io``), timing, profiling,
the NaN debug modes and sorting networks (``utils``), the reference's
``roo::`` names (``roo``) and the demo programs (``examples``, each run as
``python -m kangaroo_tpu_torch.examples.<name>_demo``). As the JAX
package, the package exports its containers and core modules.
"""

from .containers.bbox import BoundingBox, fit_to_frustum
from .containers.intrinsics import Intrinsics, level_from_max_pixels
from .containers.volume import BoundedVolume, TsdfVolume
from .containers import pyramid
from .core import invalid, patch_score, reweighting, sampling, se3
from .ops import convert, elementwise, resample

__version__ = "0.1.0"


def __getattr__(name):
    """Subpackages on attribute access: kangaroo_tpu_torch.stereo, .fusion,
    .variational, .geometry, .solvers, .parallel, .apps, .ops, .io, .utils,
    .roo."""
    import importlib

    if name in {"stereo", "fusion", "variational", "geometry", "solvers", "parallel", "apps",
                "ops", "io", "utils", "backend", "roo"}:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)


__all__ = [
    "BoundingBox",
    "BoundedVolume",
    "Intrinsics",
    "TsdfVolume",
    "convert",
    "elementwise",
    "fit_to_frustum",
    "invalid",
    "level_from_max_pixels",
    "pyramid",
    "resample",
    "reweighting",
    "sampling",
    "se3",
]
