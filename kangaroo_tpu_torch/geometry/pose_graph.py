"""Pose-graph optimisation (``kangaroo_tpu/geometry/pose_graph.py``).

Keyframe poses T_wk with binary relative-pose constraints and optional
unary pose priors, solved by Gauss-Newton on a device: the residuals are
SE3 logs, the Jacobian comes from ``torch.func.jacfwd``, and the 6N normal
equations solve densely (``solvers/lss.solve_spd``), which suits the tens
to hundreds of keyframes of a SLAM map. The SE3 maps run batched over the
poses and the constraints (``torch.vmap``), so an iteration is a few
hundred launches whatever the graph's size. The graph's poses are float32
NumPy arrays on the host; ``optimize`` moves them to its ``device``, reads
the residual norm once an iteration and writes the poses back.
``start`` runs the solve on a background thread.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import se3
from ..solvers.lss import solve_spd


# the SE3 maps over a batch of poses (..., 3, 4) or twists (..., 6)
_exp, _log = torch.vmap(se3.exp), torch.vmap(se3.log)
_compose, _inverse = torch.vmap(se3.compose), torch.vmap(se3.inverse)


def pack_constraints(edges, priors, device="cuda"):
    """The graph's constraints as device tensors for :func:`graph_residuals`:
    edge ends i, j (long), measurements T_ji (m, 3, 4), prior keyframes and
    measured poses T_wi (p, 3, 4); from lists of (i, j, T_ji) and (i, T_wi)."""
    def poses(Ts):
        stacked = np.stack([_pose(T) for T in Ts]) if Ts else np.zeros((0, 3, 4), np.float32)
        return torch.from_numpy(stacked).to(device)

    def index(ks):
        return torch.tensor(ks, dtype=torch.long).to(device)

    return (index([i for i, _, _ in edges]), index([j for _, j, _ in edges]),
            poses([T for _, _, T in edges]), index([i for i, _ in priors]),
            poses([T for _, T in priors]))


def graph_residuals(xi_flat, poses, edge_i, edge_j, T_ji, prior_i, T_wi) -> torch.Tensor:
    """The stacked SE3-log residuals of the graph with each pose k moved to
    exp(xi_k) poses[k] (``pack_constraints``' tensors): log(T_ji^-1 T_jw T_wi)
    per edge, then log(T_wi_measured^-1 T_wi) per prior, each a batched map
    over the constraints."""
    Ts = _compose(_exp(xi_flat.reshape(-1, 6)), poses)
    rs = []
    if edge_i.numel():
        rs.append(_log(_compose(_inverse(T_ji), _compose(_inverse(Ts[edge_j]), Ts[edge_i]))))
    if prior_i.numel():
        rs.append(_log(_compose(_inverse(T_wi), Ts[prior_i])))
    return torch.cat([r.reshape(-1) for r in rs])


@dataclasses.dataclass
class PoseGraph:
    """Keyframe poses T_wk plus constraints: ``edges`` (i, j, T_ji), the
    measured pose of frame i in frame j, and ``priors`` (i, T_wi), measured
    world poses."""

    poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    edges: List[Tuple[int, int, np.ndarray]] = dataclasses.field(default_factory=list)
    priors: List[Tuple[int, np.ndarray]] = dataclasses.field(default_factory=list)
    # the background solve's state
    _thread: Optional[threading.Thread] = dataclasses.field(default=None, repr=False,
                                                            compare=False)
    _stop_requested: bool = dataclasses.field(default=False, repr=False, compare=False)
    running: bool = dataclasses.field(default=False, compare=False)

    def add_keyframe(self, T_wk=None) -> int:
        self.poses.append(_pose(T_wk) if T_wk is not None else np.eye(3, 4, dtype=np.float32))
        return len(self.poses) - 1

    def add_relative_edge(self, i: int, j: int, T_ji) -> None:
        """Constrain T_jw * T_wi = T_ji."""
        self.edges.append((i, j, _pose(T_ji)))

    def add_prior(self, i: int, T_wi) -> None:
        self.priors.append((i, _pose(T_wi)))

    def optimize(self, iterations: int = 10, damping: float = 1e-4, fix_first: bool = True,
                 device="cuda") -> float:
        """Gauss-Newton over all poses on ``device`` (the card unless the
        caller asks for another); returns the final residual norm. Each
        iteration masks the first pose's columns (``fix_first``), solves,
        zeroes the first pose's step, composes, then reads the norm."""
        n = len(self.poses)
        if n == 0:
            return 0.0
        if not self.edges and not self.priors:
            return 0.0
        poses = torch.from_numpy(np.stack(self.poses)).to(device)  # (n, 3, 4)
        cons = pack_constraints(self.edges, self.priors, device)
        x0 = torch.zeros(n * 6, dtype=torch.float32, device=device)
        mask = (torch.arange(n * 6, device=device) >= 6).to(torch.float32)
        final = 0.0
        for _ in range(iterations):
            if self._stop_requested:
                break
            J = torch.func.jacfwd(graph_residuals)(x0, poses, *cons)
            r = graph_residuals(x0, poses, *cons)
            if fix_first:
                J = J * mask[None, :]
            dx = -solve_spd(J.T @ J, J.T @ r, damping)
            if fix_first:
                dx = torch.cat([torch.zeros_like(dx[:6]), dx[6:]])
            poses = _compose(_exp(dx.reshape(n, 6)), poses)
            final = float(torch.linalg.vector_norm(graph_residuals(x0, poses, *cons)))
        self.poses = list(poses.cpu().numpy())
        return final

    def start(self, iterations: int = 100, damping: float = 1e-4, fix_first: bool = True,
              device="cuda") -> None:
        """Run :meth:`optimize` on a background thread. The poses update when
        it finishes; poll ``running`` or call ``stop()`` / ``join()``."""
        if self.running:
            return
        self._stop_requested = False
        self.running = True

        def run():
            try:
                self.optimize(iterations=iterations, damping=damping, fix_first=fix_first,
                              device=device)
            finally:
                self.running = False

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Ask the background solve to stop after its current iteration, and
        wait for it."""
        self._stop_requested = True
        self.join()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _pose(T) -> np.ndarray:
    return np.asarray(T.detach().cpu() if torch.is_tensor(T) else T, np.float32)


def load_poses_from_file(path: str):
    """Load a pose trajectory text file: one pose a line, 12 values (a
    row-major 3x4) or 6 (x y z roll pitch yaw). Returns a list of (3, 4)
    float32 arrays."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) == 12:
                poses.append(np.asarray(vals, np.float32).reshape(3, 4))
            elif len(vals) == 6:
                x, y, z, r, p, q = vals
                cr, sr = np.cos(r), np.sin(r)
                cp, sp = np.cos(p), np.sin(p)
                cq, sq = np.cos(q), np.sin(q)
                Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
                Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
                Rz = np.array([[cq, -sq, 0], [sq, cq, 0], [0, 0, 1]])
                R = Rz @ Ry @ Rx
                T = np.concatenate([R, [[x], [y], [z]]], axis=1)
                poses.append(T.astype(np.float32))
            elif vals:
                raise ValueError(f"unsupported pose line with {len(vals)} values")
    return poses


def save_poses_to_file(path: str, poses) -> None:
    """Write a trajectory as 12-value row-major 3x4 lines, the inverse of
    :func:`load_poses_from_file`."""
    with open(path, "w") as f:
        for T in poses:
            vals = _pose(T).reshape(-1)
            f.write(" ".join(f"{v:.9g}" for v in vals) + "\n")
