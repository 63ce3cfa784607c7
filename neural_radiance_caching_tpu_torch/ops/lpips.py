"""LPIPS and E-LPIPS perceptual distances (counterpart of ``ops/lpips.py``).

The VGG-16 backbone's five taps (after relu1_2, 2_2, 3_3, 4_3, 5_3), each
unit-normalised over its channels in float32, squared difference, spatial
mean, then the 1x1 linear head, summed over the taps; inputs in [0, 1] are
mapped to [-1, 1], then shifted and scaled by the LPIPS constants. The
convolutions are ``torch.nn.functional.conv2d`` in NCHW on the device the
caller names, with cuDNN's TF32 off so that the card computes what the CPU
does to float32 rounding.

Weights. ``find_weights`` searches, in order, the explicit path, the
``NRC_LPIPS_WEIGHTS`` environment variable,
``~/.cache/neural_radiance_caching_tpu/lpips_vgg16.npz`` and
``<repo>/weights/lpips_vgg16.npz`` (the JAX package's order and files, so
one file serves both packages); ``load_params`` reads its keys
``conv{i}_w`` [3, 3, cin, cout], ``conv{i}_b`` and ``lin{j}`` (clipped at
0). Without a file ``default_params`` falls back to the uncalibrated
network: a He-initialised VGG-16 drawn with numpy's ``RandomState(1818)``
and uniform 1/C heads, weight for weight the JAX package's (the LPIPS
paper's untrained-network baseline; its values are not comparable to
published LPIPS tables, and the harness reports ``lpips_calibrated = 0``).
Parameters are numpy trees with HWIO kernels, as the JAX package holds
them; ``utils/weights.lpips_params_to_torch`` moves them to a device as
OIHW tensors, and ``lpips`` does so itself when handed a numpy tree.

E-LPIPS (``elpips``) averages LPIPS with average pooling over an ensemble
of input transformations drawn on the host with numpy (offsets, box
downscales, flips, transposes, colour scales and channel permutations), the
JAX package's draws exactly. Its network dropout shares one mask per
convolution between both images; the masks come from a ``torch.Generator``
on the computing device seeded with ``(seed * 7919 + k) & 0x7FFFFFFF`` for
sample k. The JAX package draws its masks with threefry bits, which this
package does not reproduce, so E-LPIPS equals the JAX value only with
``dropout_keep=1.0`` (no dropout); with dropout both are draws of the same
ensemble.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# (in_channels, out_channels) of each 3x3 convolution of VGG-16.
VGG_CONVS = (
    (3, 64), (64, 64),
    (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512),
)
# Index into VGG_CONVS of the last convolution of each slice (the taps).
SLICE_ENDS = (1, 3, 6, 9, 12)
SLICE_CHANNELS = (64, 128, 256, 512, 512)

# Inputs in [0, 1] go to [-1, 1], then (x - shift) / scale per channel.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_FALLBACK_SEED = 1818


def _default_paths():
    return (
        os.environ.get("NRC_LPIPS_WEIGHTS", ""),
        os.path.expanduser("~/.cache/neural_radiance_caching_tpu/lpips_vgg16.npz"),
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "weights", "lpips_vgg16.npz"),
    )


def find_weights(path: Optional[str] = None) -> Optional[str]:
    """The first existing file among `path` and the default search paths."""
    for p in (path,) + _default_paths():
        if p and os.path.isfile(p):
            return p
    return None


def load_params(path: Optional[str] = None):
    """Calibrated params (``calibrated=True``) from the first weights file
    found, or None."""
    path = find_weights(path)
    if path is None:
        return None
    data = np.load(path)
    convs = []
    for i, (cin, cout) in enumerate(VGG_CONVS):
        w = np.asarray(data[f"conv{i}_w"], np.float32)
        b = np.asarray(data[f"conv{i}_b"], np.float32)
        if w.shape != (3, 3, cin, cout) or b.shape != (cout,):
            raise ValueError(f"conv{i} shape mismatch in {path}: {w.shape}, {b.shape}")
        convs.append((w, b))
    lins = []
    for j, c in enumerate(SLICE_CHANNELS):
        lin = np.asarray(data[f"lin{j}"], np.float32).reshape(-1)
        if lin.shape != (c,):
            raise ValueError(f"lin{j} shape mismatch in {path}: {lin.shape}")
        lins.append(np.maximum(lin, 0.0))
    return {"convs": convs, "lins": lins, "calibrated": True}


def _he_convs(rng):
    convs = []
    for cin, cout in VGG_CONVS:
        std = np.sqrt(2.0 / (9 * cin))
        w = rng.normal(0.0, std, (3, 3, cin, cout)).astype(np.float32)
        convs.append((w, np.zeros((cout,), np.float32)))
    return convs


def synthesize_params(seed: int = 0):
    """Deterministic random params for shape tests (``calibrated=False``)."""
    rng = np.random.RandomState(seed)
    convs = _he_convs(rng)
    lins = [rng.uniform(0.0, 1.0, (c,)).astype(np.float32) / c for c in SLICE_CHANNELS]
    return {"convs": convs, "lins": lins, "calibrated": False}


def fallback_params():
    """The uncalibrated network: He-initialised convolutions from the fixed
    seed, uniform 1/C heads (``calibrated=False``)."""
    convs = _he_convs(np.random.RandomState(_FALLBACK_SEED))
    lins = [np.full((c,), 1.0 / c, np.float32) for c in SLICE_CHANNELS]
    return {"convs": convs, "lins": lins, "calibrated": False}


def default_params(path: Optional[str] = None):
    """Calibrated params where a weights file exists, else the fallback."""
    params = load_params(path)
    return params if params is not None else fallback_params()


def _on_device(params, device):
    if isinstance(params["lins"][0], torch.Tensor):
        return params
    from neural_radiance_caching_tpu_torch.utils import weights

    return weights.lpips_params_to_torch(params, device)


def _features(params, x, pool, dropout_rng, dropout_keep):
    """The five taps of x [2N, 3, H, W] (both images of each pair, which
    share each convolution's dropout mask). A tap after a pooling that
    leaves no pixel (an image under 16 pixels on a side) is None."""
    feats = []
    n = x.shape[0] // 2
    for i, (w, b) in enumerate(params["convs"]):
        if x is not None:
            if dropout_rng is not None:
                u = torch.rand((n,) + tuple(x.shape[1:]), generator=dropout_rng,
                               device=dropout_rng.device).to(x.device)
                mask = (u < dropout_keep).to(x.dtype) / dropout_keep
                x = x * torch.cat([mask, mask])
            x = torch.relu(F.conv2d(x, w, b, padding=1))
        if i in SLICE_ENDS:
            feats.append(x)
            if x is not None and i != SLICE_ENDS[-1]:
                if min(x.shape[-2:]) < 2:
                    x = None
                else:
                    x = F.max_pool2d(x, 2) if pool == "max" else F.avg_pool2d(x, 2)
    return feats


def _normalize(f, eps=1e-10):
    f = f.float()
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def lpips(params, img0, img1, pool="max", dropout_rng=None, dropout_keep=0.99, device=None):
    """LPIPS distance of images in [0, 1], [H, W, 3] (a scalar tensor) or
    [N, H, W, 3] (an [N] tensor), computed on `device` (by default the
    device of `img0` where it is a tensor, else the CPU). `dropout_rng` (a
    torch.Generator) turns on E-LPIPS's shared network dropout."""
    if device is None:
        device = img0.device if isinstance(img0, torch.Tensor) else "cpu"
    params = _on_device(params, device)
    img0 = torch.as_tensor(np.asarray(img0) if not isinstance(img0, torch.Tensor) else img0,
                           dtype=torch.float32, device=device)
    img1 = torch.as_tensor(np.asarray(img1) if not isinstance(img1, torch.Tensor) else img1,
                           dtype=torch.float32, device=device)
    squeeze = img0.dim() == 3
    if squeeze:
        img0, img1 = img0[None], img1[None]
    shift = torch.as_tensor(_SHIFT, device=device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=device).reshape(1, 3, 1, 1)
    x = torch.cat([img0, img1]).permute(0, 3, 1, 2)
    x = (x * 2.0 - 1.0 - shift) / scale
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic, allow_tf32=False):
        feats = _features(params, x, pool, dropout_rng, dropout_keep)
        n = img0.shape[0]
        total = 0.0
        for f, lin in zip(feats, params["lins"]):
            if f is None:
                # The mean over no pixel, as JAX takes it.
                total = total + torch.full((n,), float("nan"), device=x.device)
                continue
            diff = torch.square(_normalize(f[:n]) - _normalize(f[n:]))
            # Spatial mean first, then the linear head.
            total = total + torch.sum(torch.mean(diff, dim=(2, 3)) * lin, dim=-1)
    return total[0] if squeeze else total


# --- E-LPIPS: LPIPS over an ensemble of input transformations ------------------------------


def _sample_transform(rng, h, w, num_scales, offset_max=7):
    probs = np.array([1.0 / i**2 for i in range(1, num_scales + 1)])
    probs /= probs.sum()
    scale = int(rng.choice(num_scales, p=probs)) + 1
    return {
        "offset": rng.randint(0, offset_max + 1, size=2),
        "scale": scale,
        "scale_offset": rng.randint(0, scale, size=2),
        "flip": int(rng.randint(4)),
        "swap": int(rng.randint(2)),
        "color": (0.2 + 0.8 * rng.uniform(size=3)).astype(np.float32),
        "perm": rng.permutation(3),
    }


def _apply_transform(img, t):
    """One sampled transformation of an [H, W, 3] host image: the offset
    crop, the box downscale (cropped to a multiple of the scale), the flips,
    the transpose, the channel permutation and colour scale."""
    img = np.asarray(img, np.float32)
    oy, ox = t["offset"]
    img = img[oy:, ox:]
    s = t["scale"]
    if s > 1:
        sy, sx = t["scale_offset"]
        img = img[sy:, sx:]
        hh, ww = (img.shape[0] // s) * s, (img.shape[1] // s) * s
        img = img[:hh, :ww].reshape(hh // s, s, ww // s, s, 3).mean((1, 3))
    if t["flip"] & 1:
        img = img[:, ::-1]
    if t["flip"] & 2:
        img = img[::-1]
    if t["swap"]:
        img = np.swapaxes(img, 0, 1)
    img = img[..., t["perm"]] * t["color"]
    return np.ascontiguousarray(img)


def elpips(params, img0, img1, num_samples=8, seed=0, num_scales=None, dropout_keep=0.99,
           device="cpu"):
    """E-LPIPS of two [H, W, 3] images in [0, 1]: the mean of
    `num_samples` average-pooled LPIPS distances, each between both images
    under one sampled transformation (the crop-based approximate mode);
    ``num_scales`` defaults to min(H, W) // 64, at least 1. Deterministic in
    `seed` on one device; ``dropout_keep=1.0`` turns the dropout off."""
    img0 = np.asarray(img0, np.float32)
    img1 = np.asarray(img1, np.float32)
    h, w = img0.shape[:2]
    if num_scales is None:
        num_scales = max(1, min(h, w) // 64)
    params = _on_device(params, device)
    rng = np.random.RandomState(seed)
    vals = []
    for k in range(num_samples):
        t = _sample_transform(rng, h, w, num_scales)
        a, b = _apply_transform(img0, t), _apply_transform(img1, t)
        drop_rng = None
        if dropout_keep < 1.0:
            drop_rng = torch.Generator(device=device).manual_seed(
                (seed * 7919 + k) & 0x7FFFFFFF)
        vals.append(float(lpips(params, a, b, pool="avg", dropout_rng=drop_rng,
                                dropout_keep=dropout_keep, device=device)))
    return float(np.mean(vals))
