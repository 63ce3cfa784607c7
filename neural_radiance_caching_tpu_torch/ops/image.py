"""Colour-space transfer and image metrics (counterpart of ``ops/image.py``:
``linear_to_srgb``, ``srgb_to_linear`` (on host arrays, for the loaders),
``mse_to_psnr``, ``psnr``, ``ssim`` and
``MetricHarness``).

SSIM is Wang et al. 2004 with the 11-tap, sigma 1.5 Gaussian window, blurred
separably (one depthwise convolution per image axis) over symmetric padding,
as the JAX function computes it. The metrics take tensors or numpy arrays
and compute on the device of their input; the harness takes host arrays.
LPIPS (the JAX harness's untrained-VGG fallback) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_F32_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=None):
    """Linear -> sRGB transfer."""
    if eps is None:
        eps = _F32_EPS
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb, eps=None):
    """sRGB -> linear transfer of a host array (the loaders' colour
    conversion), as the JAX function computes it on one: the affine parts in
    the input's dtype, the power in float32; a float32 result."""
    if eps is None:
        eps = _F32_EPS
    srgb = np.asarray(srgb)
    linear0 = (25 / 323 * srgb).astype(np.float32)
    linear1 = np.maximum(np.float32(eps), ((200 * srgb + 11) / 211).astype(np.float32)) ** (12 / 5)
    return np.where(srgb <= 0.04045, linear0, linear1)


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * torch.log(torch.as_tensor(mse))


def psnr(img0, img1):
    return mse_to_psnr(torch.mean((torch.as_tensor(img0) - torch.as_tensor(img1)) ** 2))


def _gaussian_kernel(size, sigma):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.as_tensor(k / k.sum(), dtype=torch.float32)


def _symmetric_index(n, pad, device):
    """Source index of each position of an axis of length n padded by `pad`
    on both sides in numpy's "symmetric" mode (the edge sample repeated)."""
    j = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03,
         return_map=False):
    """Structural similarity of two [H, W, ...] images in [0, max_val]."""
    img0 = torch.as_tensor(img0, dtype=torch.float32)
    img1 = torch.as_tensor(img1, dtype=torch.float32)
    h, w = img0.shape[:2]
    pad = filter_size // 2
    kernel = _gaussian_kernel(filter_size, filter_sigma).to(img0.device)
    rows = _symmetric_index(h, pad, img0.device)
    cols = _symmetric_index(w, pad, img0.device)

    def blur(x):
        # [H, W, ...] -> [1, C, H, W], one depthwise 1-D convolution per axis.
        c = int(np.prod(x.shape[2:], dtype=np.int64))
        x = x.reshape(h, w, c).permute(2, 0, 1)[None]
        x = F.conv2d(x.index_select(2, rows), kernel.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                     groups=c)
        x = F.conv2d(x.index_select(3, cols), kernel.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                     groups=c)
        return x[0].permute(1, 2, 0).reshape(img0.shape)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = blur(img0 * img0) - mu00
    sigma11 = blur(img1 * img1) - mu11
    sigma01 = blur(img0 * img1) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else torch.mean(ssim_map)


class MetricHarness:
    """PSNR and SSIM of a rendering against its ground truth (host arrays).

    LPIPS is not ported yet: neither the JAX harness's untrained-VGG
    fallback nor its calibrated weights, which would need a download. So the
    harness must be built with ``disable_lpips=True``.
    """

    def __init__(self, disable_lpips=False, **kwargs):
        del kwargs
        if not disable_lpips:
            raise NotImplementedError(
                "LPIPS (the untrained-VGG fallback of the JAX harness) is not ported yet; "
                "build the harness with disable_lpips=True")

    def __call__(self, rgb_pred, rgb_gt, name_fn=lambda s: s):
        # float32, as the JAX harness computes (no 64-bit arrays there).
        pred = torch.as_tensor(np.asarray(rgb_pred, np.float32))
        gt = torch.as_tensor(np.asarray(rgb_gt, np.float32))
        return {name_fn("psnr"): float(psnr(pred, gt)), name_fn("ssim"): float(ssim(pred, gt))}
