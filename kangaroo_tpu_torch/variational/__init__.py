"""Variational solvers: ROF/Huber-ROF, TGV-L1, deconvolution, inpainting,
and the ROF and TGV kernels."""
from . import deconvolution, ops, rof, tgv
