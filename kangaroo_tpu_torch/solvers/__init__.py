"""Solvers: Gauss-Newton normal equations, projective ICP and the robust plane fit."""
from . import icp, lss, plane_fit
