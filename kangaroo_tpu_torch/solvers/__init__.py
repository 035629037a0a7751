"""Solvers: Gauss-Newton normal equations and projective ICP."""
from . import icp, lss
