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
variational solvers (``variational``) and the KinectFusion frame on the
plane-sweep engine (``apps.kinectfusion``).
"""

__version__ = "0.1.0"
