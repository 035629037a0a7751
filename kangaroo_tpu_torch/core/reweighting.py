"""IRLS robust-loss weights (``kangaroo_tpu/core/reweighting.py``): squared,
L1, Huber, Tukey and Cauchy, and ``WEIGHT_FNS`` by name. The ICP takes the
Tukey weight."""
from __future__ import annotations

import torch


def weight_sq(r, c=None):
    return torch.ones_like(torch.as_tensor(r, dtype=torch.float32))


def weight_l1(r, c=None):
    return 1.0 / torch.abs(r)


def weight_huber(r, c):
    absr = torch.abs(r)
    return torch.where(absr <= c, 1.0, c / absr)


def weight_tukey(r, c):
    absr = torch.abs(r)
    roc = r / c
    om = 1.0 - roc * roc
    return torch.where(absr <= c, om * om, 0.0)


def weight_cauchy(r, c):
    roc = r / c
    return 1.0 / (1.0 + roc * roc)


WEIGHT_FNS = {
    "sq": weight_sq,
    "l1": weight_l1,
    "huber": weight_huber,
    "tukey": weight_tukey,
    "cauchy": weight_cauchy,
}
