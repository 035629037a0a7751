"""IRLS robust-loss weights (``kangaroo_tpu/core/reweighting.py``): the
Tukey weight of the ICP; the squared, L1, Huber and Cauchy weights have no
caller on the ported paths yet."""
from __future__ import annotations

import torch


def weight_tukey(r, c):
    absr = torch.abs(r)
    roc = r / c
    om = 1.0 - roc * roc
    return torch.where(absr <= c, om * om, 0.0)
