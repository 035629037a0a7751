"""Gauss-Newton normal-equation systems (``kangaroo_tpu/solvers/lss.py``).

The per-pixel Jacobian rows reduce with two float32 matmuls (JTJ, JTy); the
SPD solve is a Cholesky factorisation, in float32 as the JAX package's,
without a host read (``cholesky_ex``): a matrix that is not positive
definite yields NaN, as ``jnp.linalg.cholesky`` does, for the callers'
finiteness guards. Systems merge with ``+``; ``LSS.zero`` is the empty one.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LSS:
    """Normal equations JTJ x = JTy plus error statistics."""

    JTJ: torch.Tensor  # (N, N)
    JTy: torch.Tensor  # (N,)
    sqErr: torch.Tensor  # ()
    obs: torch.Tensor  # ()

    @classmethod
    def zero(cls, n: int, device="cuda") -> "LSS":
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
        return cls(z(n, n), z(n), z(), z())

    def __add__(self, o: "LSS") -> "LSS":
        return LSS(self.JTJ + o.JTJ, self.JTy + o.JTy, self.sqErr + o.sqErr, self.obs + o.obs)

    def rmse(self) -> torch.Tensor:
        """sqrt(sqErr / obs): NaN when nothing was observed, so a total
        tracking loss triggers the app's reset rather than a perfect 0."""
        return torch.sqrt(self.sqErr / self.obs)

    def solve(self, damping=0.0) -> torch.Tensor:
        return solve_spd(self.JTJ, self.JTy, damping)


def solve_spd(A: torch.Tensor, b: torch.Tensor, damping=0.0) -> torch.Tensor:
    """Solve the SPD system (A + damping I) x = b by Cholesky."""
    A = A + damping * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, float("nan"))
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def reduce_system(J, y, w, valid) -> LSS:
    """Reduce per-pixel rows J (..., N), residuals y, IRLS weights w and a
    validity mask into an LSS; invalid rows contribute nothing."""
    n = J.shape[-1]
    vf = valid.reshape(-1)
    wf = torch.where(vf, w.reshape(-1), 0.0)
    # scrub NaNs from masked-out rows so they cannot poison the matmul
    Jf = torch.where(vf[:, None], J.reshape(-1, n), 0.0)
    yf = torch.where(vf, y.reshape(-1), 0.0)
    wJ = Jf * wf[:, None]
    return LSS(wJ.T @ Jf, wJ.T @ yf, torch.where(vf, yf * yf, 0.0).sum(),
               vf.to(torch.float32).sum())
