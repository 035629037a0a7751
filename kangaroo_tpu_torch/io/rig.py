"""Camera-model / rig file loading (``kangaroo_tpu/io/rig.py``).

Host-side NumPy, float64 as in the JAX package. Capability-equivalent of
extra/CameraModelPyramid.h (:1-140 — per-level K and Kinv populated from
an mvl/calibu camera-model file), extra/CamParam.h and
extra/BaselineFromCamModel.h (:1-23 — stereo T_rl from two posed camera
models with RDF adjustment). The mvl XML schema is dead tooling; the rig
file here is JSON:

    {"cameras": [
        {"name": "left", "width": 640, "height": 480,
         "fu": 570.3, "fv": 570.3, "u0": 319.5, "v0": 239.5,
         "T_wc": [ ... 12 row-major values of [R|t] ... ],   # optional
         "RDF":  [ ... 9 row-major values ... ]              # optional
        }, ...]}

``T_wc`` may also be 6 values (x y z roll pitch yaw). Everything else in
the reference header (ScaleK, MakeK(inv), GetLevelFromMaxPixels, ROI crop)
is reproduced as plain functions.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from ..containers.intrinsics import Intrinsics


def make_k(fu, fv, u0, v0) -> np.ndarray:
    """MakeK (CameraModelPyramid.h:84-91)."""
    return np.array([[fu, 0, u0], [0, fv, v0], [0, 0, 1]], np.float64)


def make_k_inv(fu, fv, u0, v0) -> np.ndarray:
    """MakeKinv (CameraModelPyramid.h:93-100)."""
    return np.array(
        [[1.0 / fu, 0, -u0 / fu], [0, 1.0 / fv, -v0 / fv], [0, 0, 1]],
        np.float64,
    )


def scale_k(K: np.ndarray, s: float) -> np.ndarray:
    """ScaleK (CameraModelPyramid.h:74-82): pixel-centre-correct scaling."""
    out = np.array(K, np.float64)
    out[0, 0] *= s
    out[1, 1] *= s
    out[0, 2] = s * (K[0, 2] + 0.5) - 0.5
    out[1, 2] = s * (K[1, 2] + 0.5) - 0.5
    return out


def level_from_max_pixels(w: int, h: int, max_pixels: int) -> int:
    """GetLevelFromMaxPixels (CameraModelPyramid.h:27-34)."""
    level = 0
    while (w >> level) * (h >> level) > max_pixels:
        level += 1
    return level


def centered_aligned_region(w: int, h: int, bx: int, by: int):
    """GetCenteredAlignedRegion (CameraModelPyramid.h:17-25) ->
    (x, y, width, height)."""
    rw = bx * (w // bx)
    rh = by * (h // by)
    return (w - rw) // 2, (h - rh) // 2, rw, rh


def _pose_from_values(vals) -> np.ndarray:
    vals = list(vals)
    if len(vals) == 12:
        return np.asarray(vals, np.float32).reshape(3, 4)
    if len(vals) == 6:
        x, y, z, r, p, q = vals
        cr, sr = np.cos(r), np.sin(r)
        cp, sp = np.cos(p), np.sin(p)
        cq, sq = np.cos(q), np.sin(q)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cq, -sq, 0], [sq, cq, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        return np.concatenate([R, [[x], [y], [z]]], axis=1).astype(np.float32)
    raise ValueError(f"pose needs 12 or 6 values, got {len(vals)}")


@dataclasses.dataclass
class CameraModel:
    """One camera of a rig: intrinsics + image size + pose + axis convention
    (mvl::CameraModel role)."""

    name: str
    width: int
    height: int
    fu: float
    fv: float
    u0: float
    v0: float
    T_wc: np.ndarray  # (3, 4) camera-to-world
    RDF: np.ndarray  # (3, 3) axis convention (identity = RDF already)

    def K(self, level: int = 0) -> np.ndarray:
        """Per-pyramid-level K (CameraModelPyramid::K, :121-124)."""
        return scale_k(make_k(self.fu, self.fv, self.u0, self.v0),
                       1.0 / (1 << level))

    def Kinv(self, level: int = 0) -> np.ndarray:
        return np.linalg.inv(self.K(level))

    def intrinsics(self, level: int = 0) -> Intrinsics:
        """The port's ``Intrinsics`` of ``K(level)``, each field rounded to
        float32 (``Intrinsics.create``): the JAX package's Python floats
        enter its float32 ops rounded the same way."""
        K = self.K(level)
        return Intrinsics.create(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))

    def size(self, level: int = 0):
        return self.width >> level, self.height >> level

    def pyramid(self, max_levels: int = 10) -> List[np.ndarray]:
        """PopulatePyramid (CameraModelPyramid.h:130-140): K per level while
        the image dimensions stay positive."""
        out = []
        level = 0
        while level <= max_levels and (self.width >> level) > 0 and (
                self.height >> level) > 0:
            out.append(self.K(level))
            level += 1
        return out

    def scaled_to(self, w: int, h: int) -> "CameraModel":
        """CamModelScaleToDimensions (CameraModelPyramid.h:58-62)."""
        s = w / self.width
        K = scale_k(make_k(self.fu, self.fv, self.u0, self.v0), s)
        return dataclasses.replace(
            self, width=w, height=h, fu=float(K[0, 0]), fv=float(K[1, 1]),
            u0=float(K[0, 2]), v0=float(K[1, 2]),
        )

    def cropped_to(self, x: int, y: int, w: int, h: int) -> "CameraModel":
        """CamModelCropToRegionOfInterest (CameraModelPyramid.h:64-71)."""
        return dataclasses.replace(
            self, width=w, height=h, u0=self.u0 - x, v0=self.v0 - y,
        )


@dataclasses.dataclass
class Rig:
    cameras: Dict[str, CameraModel]

    def __getitem__(self, name: str) -> CameraModel:
        return self.cameras[name]

    def names(self):
        return list(self.cameras)

    def t_rl(self, left: str, right: str,
             target_rdf: Optional[np.ndarray] = None) -> np.ndarray:
        """Right-from-left transform T_rl from the two camera poses with
        RDF adjustment (T_rlFromCamModelRDF, BaselineFromCamModel.h:5-23)."""
        lc, rc = self.cameras[left], self.cameras[right]
        rdf = np.eye(3) if target_rdf is None else np.asarray(target_rdf)

        def t_cw_adjusted(cam: CameraModel) -> np.ndarray:
            adj = rdf.T @ cam.RDF  # (3, 3)
            T_wc = np.eye(4)
            T_wc[:3] = cam.T_wc
            T_cw = np.linalg.inv(T_wc)
            T_cw[:3, :3] = adj @ T_cw[:3, :3]
            T_cw[:3, 3] = adj @ T_cw[:3, 3]
            return T_cw

        T_lw = t_cw_adjusted(lc)
        T_rw = t_cw_adjusted(rc)
        T_rl = T_rw @ np.linalg.inv(T_lw)
        return T_rl[:3].astype(np.float32)

    def baseline(self, left: str = None, right: str = None) -> float:
        """Stereo baseline in metres (the `-cmod` path of stereo/main.cpp:
        |T_rl.translation()|)."""
        names = self.names()
        left = left or names[0]
        right = right or names[1]
        return float(np.linalg.norm(self.t_rl(left, right)[:, 3]))


def load_rig(path: str) -> Rig:
    """Load a JSON rig file (see module docstring for the schema)."""
    with open(path) as f:
        spec = json.load(f)
    cams = {}
    for c in spec["cameras"]:
        T = _pose_from_values(c.get("T_wc", np.eye(3, 4).reshape(-1).tolist()))
        rdf = np.asarray(c.get("RDF", np.eye(3).reshape(-1).tolist()),
                         np.float64).reshape(3, 3)
        cams[c["name"]] = CameraModel(
            name=c["name"], width=int(c["width"]), height=int(c["height"]),
            fu=float(c["fu"]), fv=float(c["fv"]), u0=float(c["u0"]),
            v0=float(c["v0"]), T_wc=T, RDF=rdf,
        )
    return Rig(cams)


def save_rig(path: str, rig: Rig) -> None:
    """Inverse of :func:`load_rig` (the SaveMvlCamModel role)."""
    spec = {"cameras": []}
    for cam in rig.cameras.values():
        spec["cameras"].append({
            "name": cam.name, "width": cam.width, "height": cam.height,
            "fu": cam.fu, "fv": cam.fv, "u0": cam.u0, "v0": cam.v0,
            "T_wc": np.asarray(cam.T_wc, np.float64).reshape(-1).tolist(),
            "RDF": np.asarray(cam.RDF, np.float64).reshape(-1).tolist(),
        })
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
