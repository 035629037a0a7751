"""Solvers: Gauss-Newton normal equations, projective ICP, the robust plane
fit, photometric pose refinement, calibration and the Manhattan frame."""
from . import calibration, icp, lss, manhattan, photometric, plane_fit
