"""Plain reference of the multi-view keyframe: the seed volume, the running
mean over posed views, the volume on the solver's scale and the DTAM solve.

Written from the method's definition with plain PyTorch operations; it
imports nothing of the program. Volumes are (D, H, W) running means kept as
a count n and a sum s per cell:

- the seed, from the keyframe's rectified pair: the zero-mean SAD of the
  (2 rad + 1)^2 patches at x and x - d, where both patches lie inside the
  image (n = 1), else nothing (n = s = 0);
- a posed view T_wc: each cell (d, v, u) is unprojected at depth
  fu b / max(d, 1e-9) in the keyframe's camera, projected into the view
  through K T_cw T_wv, and where it lands in front of the camera and 5
  pixels inside the image, n gains 1 and s the zero-mean SAD of the
  keyframe's patch (integer taps, edges clamped) against the view's
  (bilinear taps), over the patch area;
- the volume s / n / 255 clipped to [0, 1e6] (1e30 / 255 where n = 0);
- the DTAM solve: d = a = the subpixel WTA of the volume, q = 0, then per
  iteration the edge-weighted Huber dual ascent on q, the weighted primal
  descent on d, the exhaustive search a = argmin (d - a)^2 / (2 theta) +
  lam C(a) with its parabola step, and theta <- theta (1 - beta (n0 + i)).

``dtype`` sets the precision of the costs (the patch means, the SAD, the
running sums and the volume the solve reads; the geometry and the solver's
state stay float32): float32 is the keyframe as configured, bfloat16 the
control that the comparison has to reject.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WTA_BIG = 1e10


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[clamp(y + dy), clamp(x + dx)]."""
    H, W = img.shape
    ys = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[ys][:, xs]


def _box_sum(img: torch.Tensor, rad: int) -> torch.Tensor:
    """Sum over the (2 rad + 1)^2 window, zeros outside the image."""
    k = 2 * rad + 1
    c = torch.cumsum(F.pad(img, (0, 0, rad + 1, rad)), dim=0)
    img = c[k:] - c[:-k]
    c = torch.cumsum(F.pad(img, (rad + 1, rad)), dim=1)
    return c[:, k:] - c[:, :-k]


def seed_volume(left: torch.Tensor, right: torch.Tensor, D: int, rad: int, dtype):
    """(n, s) of the rectified pair's zero-mean SAD, left-anchored."""
    H, W = left.shape
    dev = left.device
    fl, fr = left.to(dtype), right.to(dtype)
    area = torch.tensor((2 * rad + 1) ** 2, dtype=dtype, device=dev)
    mean_l = _box_sum(fl, rad) / area
    mean_r = _box_sum(fr, rad) / area
    x = torch.arange(W, device=dev)
    y = torch.arange(H, device=dev)[:, None]
    inner = (x >= rad) & (x < W - rad) & (y >= rad) & (y < H - rad)
    xr = x[None, :] - torch.arange(D, device=dev)[:, None]  # (D, W)
    ok = inner[None] & ((xr >= rad) & (xr < W - rad))[:, None, :]
    xi = xr.clamp(0, W - 1)

    def at(img, cols):  # img[:, cols] for (D, W) columns -> (D, H, W)
        return img[:, cols.reshape(-1)].reshape(H, D, W).transpose(0, 1)

    mean_r_at = at(mean_r, xi)
    s = torch.zeros((D, H, W), dtype=dtype, device=dev)
    for dy in range(-rad, rad + 1):
        ys = (y[:, 0] + dy).clamp(0, H - 1)
        row_l, row_r = fl[ys], fr[ys]
        for dx in range(-rad, rad + 1):
            a = row_l[:, (x + dx).clamp(0, W - 1)] - mean_l
            b = at(row_r, (xi + dx).clamp(0, W - 1)) - mean_r_at
            s += (a - b).abs()
    return ok.to(dtype), torch.where(ok, s, torch.zeros((), dtype=dtype, device=dev))


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img at finite (x, y), the four taps clamped to the image, each lerp
    a fused multiply-add."""
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xa, xb = x0.clamp(0, W - 1).long(), (x0 + 1).clamp(0, W - 1).long()
    ya, yb = y0.clamp(0, H - 1).long(), (y0 + 1).clamp(0, H - 1).long()
    flat = img.reshape(-1)
    tl, tr = flat[ya * W + xa], flat[ya * W + xb]
    bl, br = flat[yb * W + xa], flat[yb * W + xb]
    top = torch.addcmul(tl, tr - tl, fx)
    bot = torch.addcmul(bl, br - bl, fx)
    return torch.addcmul(top, bot - top, fy)


def projection(K: dict, T_wc: np.ndarray, device) -> torch.Tensor:
    """K T_cw T_wv (3, 4) in float32 on ``device`` for a keyframe at the
    identity pose and a view at T_wc (3, 4): T_cw = [R^T | -R^T t], each
    product a float32 matrix product."""
    T = torch.as_tensor(T_wc, dtype=torch.float32, device=device)
    Rt = T[:, :3].T
    Km = torch.tensor([[K["fu"], 0.0, K["u0"]], [0.0, K["fv"], K["v0"]], [0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=device)
    return Km @ torch.cat([Rt, -Rt @ T[:, 3:]], dim=1)


def add_view(n, s, key: torch.Tensor, view: torch.Tensor, M: torch.Tensor, K: dict,
             baseline: float, rad: int, dtype):
    """(n, s) with the posed view accumulated (M = ``projection``). The
    geometry and the bilinear taps are float32; the patch means, the SAD and
    the running sums are in ``dtype``."""
    D, H, W = n.shape
    dev = n.device
    f32 = torch.float32

    def c(v, dt=f32):
        return torch.tensor(float(v), dtype=dt, device=dev)

    fu, fv, u0, v0, base = c(K["fu"]), c(K["fv"]), c(K["u0"]), c(K["v0"]), c(baseline)
    area = c((2 * rad + 1) ** 2, dtype)
    v, u = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                          torch.arange(W, dtype=f32, device=dev), indexing="ij")
    z = fu * base / torch.maximum(torch.arange(D, dtype=f32, device=dev), c(1e-9))
    z = z[:, None, None]
    P = (z * (u - u0) / fu, z * (v - v0) / fv, z)
    Mt = M.to(f32)

    def row(i):
        acc = torch.addcmul(P[0] * Mt[i, 0], P[1], Mt[i, 1])
        return torch.addcmul(acc, P[2], Mt[i, 2]) + Mt[i, 3]

    kz = row(2)
    pu, pv = row(0) / kz, row(1) / kz
    ok = (kz > 0) & (pu >= 5) & (pu < W - 5) & (pv >= 5) & (pv < H - 5)
    del P, kz
    pu, pv = torch.where(ok, pu, 0.0), torch.where(ok, pv, 0.0)
    fk, fc = key.to(f32), view.to(f32)
    taps = [(dy, dx) for dy in range(-rad, rad + 1) for dx in range(-rad, rad + 1)]
    a = [_shift(fk, dy, dx).to(dtype) for dy, dx in taps]
    b = [_bilinear(fc, pu + dx, pv + dy).to(dtype) for dy, dx in taps]
    del pu, pv
    mean_a = sum(a[1:], a[0].clone()) / area
    mean_b = b[0].clone()
    for b_k in b[1:]:
        mean_b += b_k
    mean_b /= area
    sad = torch.zeros_like(mean_b)
    for a_k, b_k in zip(a, b):
        sad += ((a_k - mean_a) - (b_k - mean_b)).abs()
    del b
    zero = torch.zeros((), dtype=dtype, device=dev)
    return n + ok.to(dtype), s + torch.where(ok, sad / area, zero)


def volume(n: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The running mean on the solver's scale, float32."""
    n, s = n.to(torch.float32), s.to(torch.float32)
    mean = torch.where(n > 0, s / torch.clamp(n, min=1.0), 1e30)
    scale = torch.tensor(255.0, dtype=torch.float32, device=n.device)
    return torch.clamp(mean / scale, 0.0, 1e6)


def _wta_subpix(vol: torch.Tensor) -> torch.Tensor:
    """First-minimum WTA over the d with x - d >= 0, with the parabola step
    where the match is interior and the step stays within one disparity."""
    D, H, W = vol.shape
    d = torch.arange(D, device=vol.device)[:, None, None]
    x = torch.arange(W, device=vol.device)[None, None, :]
    masked = torch.where(x - d >= 0, vol, torch.full((), WTA_BIG, dtype=vol.dtype,
                                                      device=vol.device))
    best = torch.argmin(masked, dim=0)
    bc = masked.gather(0, best[None])[0]
    sl = vol.gather(0, (best - 1).clamp(0, D - 1)[None])[0]
    sr = vol.gather(0, (best + 1).clamp(0, D - 1)[None])[0]
    bf = best.to(vol.dtype)
    sub = bf - (sr - sl) / (2.0 * (sr - 2.0 * bc + sl))
    xr = torch.arange(W, device=vol.device) - best
    keep = (xr > 0) & (xr < W - 1) & (sub > bf - 1) & (sub < bf + 1)
    return torch.where(keep, sub, bf)


def _search(vol, last, lam, theta) -> torch.Tensor:
    """argmin_d (last - d)^2 / (2 theta) + lam vol[d] over x - d >= 0, with
    the parabola step through the penalised costs at best -+ 1."""
    D, H, W = vol.shape
    dt = vol.dtype
    inv2 = 1.0 / (2.0 * theta)
    d = torch.arange(D, dtype=dt, device=vol.device)[:, None, None]
    e = last[None] - d
    cost = inv2 * (e * e) + lam * vol
    x = torch.arange(W, device=vol.device)[None, None, :]
    ok = x - torch.arange(D, device=vol.device)[:, None, None] >= 0
    masked = torch.where(ok, cost, torch.full((), WTA_BIG, dtype=dt, device=vol.device))
    best = torch.argmin(masked, dim=0)
    bc = masked.gather(0, best[None])[0]
    bf = best.to(dt)
    vl = vol.gather(0, (best - 1).clamp(0, D - 1)[None])[0]
    vr = vol.gather(0, (best + 1).clamp(0, D - 1)[None])[0]
    el, er = last - (bf - 1.0), last - (bf + 1.0)
    cl = inv2 * (el * el) + lam * vl
    cr = inv2 * (er * er) + lam * vr
    sub = bf - (cr - cl) / (2.0 * (cr - 2.0 * bc + cl))
    xr = torch.arange(W, device=vol.device) - best
    keep = (xr > 0) & (xr < W - 1) & (sub > bf - 1.0) & (sub < bf + 1.0)
    return torch.where(keep, sub, bf)


def _edge_weight(img: torch.Tensor, alpha, beta) -> torch.Tensor:
    """exp(-alpha |grad I|^beta), central differences, 0 on the border."""
    H, W = img.shape
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) / 2.0
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) / 2.0
    x = torch.arange(W, device=img.device)[None, :]
    y = torch.arange(H, device=img.device)[:, None]
    gx = torch.where((x > 0) & (x < W - 1), gx, 0.0)
    gy = torch.where((y > 0) & (y < H - 1), gy, 0.0)
    return torch.exp(-alpha * torch.pow(torch.sqrt(gx * gx + gy * gy), beta))


def _grad(u):
    """Forward differences (H, W, 2), zero at the far edge."""
    return torch.stack([F.pad(u[:, 1:] - u[:, :-1], (0, 1)),
                        F.pad(u[1:] - u[:-1], (0, 0, 0, 1))], dim=-1)


def _div(p):
    """Backward-difference divergence, zero before the first row/column."""
    px, py = p[..., 0], p[..., 1]
    return px + py - F.pad(px[:, :-1], (1, 0)) - F.pad(py[:-1], (0, 0, 1, 0))


def thetas(theta, beta, n0, iterations: int) -> list[float]:
    """theta_i of each iteration, annealed in float32 one rounding at a time."""
    out, t, b = [], np.float32(theta), np.float32(beta)
    for i in range(iterations):
        out.append(float(t))
        t = t * (np.float32(1.0) - b * (np.float32(n0) + np.float32(i)))
    return out


def dtam(vol: torch.Tensor, key: torch.Tensor, cfg: dict, dtype) -> torch.Tensor:
    """The cold DTAM solve of ``vol`` on the keyframe ``key`` (uint8): the
    volume is read in ``dtype``, the state and the arithmetic are float32."""
    vol = vol.to(dtype).to(torch.float32)
    dev = vol.device

    def c(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    g = _edge_weight(key.to(torch.float32) / 255.0, c(cfg["g_alpha"]), c(cfg["g_beta"]))
    d = _wta_subpix(vol)
    a = d
    q = torch.zeros(d.shape + (2,), dtype=torch.float32, device=dev)
    sq, sd, alpha, lam = c(cfg["sigma_q"]), c(cfg["sigma_d"]), c(cfg["huber_alpha"]), c(cfg["lam"])
    for theta in thetas(cfg["theta_start"], cfg["beta"], 1.0, cfg["dtam_iterations"]):
        th = c(theta)
        q = (q + sq * g[..., None] * _grad(d)) / (1.0 + sq * alpha)
        q = q / torch.clamp(torch.sqrt((q * q).sum(dim=-1, keepdim=True)), min=1.0)
        inv = 1.0 / th
        d = (d + sd * (g * _div(q) + inv * a)) / (1.0 + sd * inv)
        a = _search(vol, d, lam, th)
    return d.to(torch.float32)


def keyframe(key, right, views, K: dict, baseline: float, cfg: dict, rad: int,
             dtype=torch.float32):
    """(volume float32 (D, H, W), disparity float32 (H, W)) of one keyframe
    cycle: the seed from the pair, each (view, T_wc) added, the solve."""
    n, s = seed_volume(key, right, cfg["max_disp"], rad, dtype)
    for img, T_wc in views:
        n, s = add_view(n, s, key, img, projection(K, T_wc, n.device), K, baseline, rad,
                      dtype)
    vol = volume(n, s)
    del n, s
    return vol, dtam(vol, key, cfg, dtype)
