"""Color-space transfer (counterpart of the part of ``ops/image.py`` the
cache slice uses)."""

from __future__ import annotations

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=None):
    """Linear -> sRGB transfer."""
    if eps is None:
        eps = _F32_EPS
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, srgb0, srgb1)
