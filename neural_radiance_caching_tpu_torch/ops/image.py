"""Colour-space transfer and image metrics (counterpart of ``ops/image.py``:
``linear_to_srgb``, ``srgb_to_linear`` (on host arrays, for the loaders),
``mse_to_psnr``, ``psnr``, ``ssim``, ``MetricHarness`` and the
shift-invariant metrics with their bilateral-grid helpers).

SSIM is Wang et al. 2004 with the 11-tap, sigma 1.5 Gaussian window, blurred
separably (one depthwise convolution per image axis) over symmetric padding,
as the JAX function computes it. The metrics take tensors or numpy arrays
and compute on the device of their input; the harness takes host arrays and
scores LPIPS (``ops/lpips``) on its own device.

The shift-invariant metrics (``shift_invariant_mse``,
``shift_invariant_ssim``) score an image against the reference at every
integer shift of a search window (the shifted image reflect-padded) and
keep, per pixel, the shift whose metric pooled over a
(2 * window_halfwidth + 1)^2 box is best. ``correct_local_color`` fits a
per-pixel affine colour transform through a bilateral grid (n-linear
splats of the normal equations, one least-squares solve per cell by SVD
with the JAX package's rank cut-off, n-linear slices back).
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


def linear_to_srgb_host(linear, eps=None):
    """Linear -> sRGB transfer of a host array (the loaders' colour
    conversion), in float32 as the JAX function computes it on one."""
    if eps is None:
        eps = _F32_EPS
    linear = np.asarray(linear, np.float32)
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * np.maximum(np.float32(eps), linear) ** (5 / 12) - 11) / 200
    return np.where(linear <= 0.0031308, srgb0, srgb1)


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
    """PSNR, SSIM and LPIPS of a rendering against its ground truth (host
    arrays): ``psnr`` and ``ssim`` on the host, and unless
    ``disable_lpips``, ``lpips`` on `device` (the card unless the caller
    asks for the CPU; there is no fallback), ``lpips_calibrated`` (1.0 with
    weights from a file, 0.0 with the untrained-VGG fallback) and
    ``avg_err``, the geometric mean of the MSE, sqrt(DSSIM) and LPIPS.

    lpips_params: a parameter tree of ``ops/lpips`` (host or device) in
    place of the weights file `lpips_weights_path` or the default search.
    """

    def __init__(self, disable_lpips=False, lpips_params=None, lpips_weights_path=None,
                 device="cuda", **kwargs):
        del kwargs
        self._lpips_params = None
        self.device = device
        if not disable_lpips:
            from neural_radiance_caching_tpu_torch.ops import lpips as lpips_lib
            from neural_radiance_caching_tpu_torch.utils import torchutil, weights

            torchutil.check_device(device, "the metric harness's LPIPS",
                                   "MetricHarness (device='cpu')")
            if lpips_params is None:
                lpips_params = lpips_lib.default_params(lpips_weights_path)
            self._lpips_params = weights.lpips_params_to_torch(lpips_params, device)
            self._lpips_fn = lpips_lib.lpips

    def __call__(self, rgb_pred, rgb_gt, name_fn=lambda s: s):
        # float32, as the JAX harness computes (no 64-bit arrays there).
        pred = torch.as_tensor(np.asarray(rgb_pred, np.float32))
        gt = torch.as_tensor(np.asarray(rgb_gt, np.float32))
        psnr_val = float(psnr(pred, gt))
        ssim_val = float(ssim(pred, gt))
        out = {name_fn("psnr"): psnr_val, name_fn("ssim"): ssim_val}
        if self._lpips_params is not None:
            lpips_val = float(self._lpips_fn(self._lpips_params, pred, gt, device=self.device))
            out[name_fn("lpips")] = lpips_val
            out[name_fn("lpips_calibrated")] = float(self._lpips_params["calibrated"])
            mse = float(np.exp(-0.1 * np.log(10.0) * psnr_val))
            sqrt_dssim = float(np.sqrt((1.0 - ssim_val) / 2.0))
            out[name_fn("avg_err")] = float(
                np.exp(np.mean(np.log([mse, sqrt_dssim, max(lpips_val, 1e-12)]))))
        return out


# --- shift-invariant metrics ----------------------------------------------------------------


def rgb_to_yuv(rgb):
    """RGB -> YUV (the tf.image.rgb_to_yuv matrix)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    mat = torch.tensor([[0.299, -0.14714119, +0.61497538],
                        [0.587, -0.28886916, -0.51496512],
                        [0.114, +0.43601035, -0.10001026]], device=rgb.device)
    return rgb @ mat


def downsample(img, factor):
    """Area downsample by `factor`, which must divide both spatial dims."""
    img = torch.as_tensor(img)
    sh = tuple(img.shape)
    if sh[0] % factor or sh[1] % factor:
        raise ValueError(f"factor {factor} does not divide image shape {sh[:2]}")
    img = img.reshape((sh[0] // factor, factor, sh[1] // factor, factor) + sh[2:])
    return img.mean((1, 3))


def precompute_nlinear_weights(coords, grid_shape):
    """The 2^D corner indices [P, D] and weights [P] of n-linear
    interpolation of points `coords` [P, D] on a grid of `grid_shape`."""
    import itertools

    coords = torch.as_tensor(coords)
    if coords.shape[-1] != len(grid_shape):
        raise ValueError(f"coord dim {tuple(coords.shape)} does not match grid dim "
                         f"{len(grid_shape)}")
    top = torch.tensor(list(grid_shape), dtype=torch.int32, device=coords.device) - 1
    idx0 = torch.clamp(torch.minimum(torch.floor(coords).to(torch.int32), top), min=0)
    weight0 = 1.0 - (coords - idx0.to(coords.dtype))
    idxs, weights = [], []
    for bits in itertools.product([0, 1], repeat=len(grid_shape)):
        bits = torch.tensor(bits, dtype=torch.int32, device=coords.device)
        idxs.append(idx0 + bits)
        weights.append(torch.prod(weight0 * (1 - 2 * bits) + bits, 1))
    return idxs, weights


def _per_point(w, values):
    return w.reshape(w.shape + (1,) * (values.dim() - 1))


def splat_to_grid(idxs, weights, hist, values):
    """`hist` (grid_shape + E) plus `values` [P, *E] splatted at the
    n-linear corners (a new tensor); a corner past the grid's end is
    dropped, as JAX's scatter drops it."""
    idx = torch.cat(idxs).long()
    splat_vals = torch.cat([_per_point(w, values) * values for w in weights])
    top = torch.tensor(hist.shape[:idx.shape[-1]], device=idx.device)
    inside = (idx < top).all(dim=-1)
    return hist.index_put(tuple(idx[inside].T), splat_vals[inside], accumulate=True)


def slice_from_grid(idxs, weights, hist):
    """The n-linear interpolation of `hist` (grid_shape + E) at the points:
    [P, *E]; a corner past the grid's end reads the last cell, as JAX's
    gather clamps it."""
    out = 0
    for w, i in zip(weights, idxs):
        top = torch.tensor(hist.shape[:i.shape[-1]], device=i.device) - 1
        v = hist[tuple(torch.minimum(i.long(), top).T)]
        out = out + _per_point(w, v) * v
    return out


def _lstsq(a, b):
    """Least squares a x = b per matrix [..., M, N], [..., M, K] by SVD,
    singular values under eps(float32) * max(M, N) times the largest taken
    as zero (the JAX package's solve)."""
    rcond = float(np.finfo(np.float32).eps) * max(a.shape[-2:])
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = s >= rcond * s[..., :1]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[..., None]
    return vh.transpose(-1, -2) @ (s_inv * (u.transpose(-1, -2) @ b))


def correct_local_color(im, im_true, *, num_spatial_bins, num_luma_bins, num_chroma_bins,
                        lstsq_eps=1e-5):
    """`im` [H, W, 3] matched to `im_true` by a per-pixel affine colour
    transform that varies smoothly over a bilateral grid (luma, two chroma
    and two spatial axes), clipped to [0, 1]."""
    im = torch.as_tensor(im, dtype=torch.float32)
    im_true = torch.as_tensor(im_true, dtype=torch.float32)
    if im.dim() != 3 or im.shape[2] != 3 or im.shape != im_true.shape:
        raise ValueError(f"Invalid input image shapes {tuple(im.shape)}, "
                         f"{tuple(im_true.shape)}")
    device = im.device
    color_grid_shape = [num_luma_bins] + [num_chroma_bins] * 2
    im_yuv = rgb_to_yuv(im) + torch.tensor([0.0, 0.5, 0.5], device=device)
    coords_color = im_yuv * (torch.tensor(color_grid_shape, dtype=torch.float32,
                                          device=device) - 1)
    coords_spatial = torch.stack(torch.meshgrid(
        *[torch.linspace(0, r - 1, s, device=device)
          for s, r in zip(im.shape[:-1], num_spatial_bins)], indexing="ij"), dim=-1)
    coords = torch.cat([coords_color, coords_spatial], dim=-1).reshape(-1, 5)
    grid_shape = color_grid_shape + list(num_spatial_bins)
    idxs, weights = precompute_nlinear_weights(coords, grid_shape)

    im1 = torch.cat([im, torch.ones_like(im[..., :1])], dim=-1)
    a_mat = im1.reshape(-1, 4)
    b_vec = im_true.reshape(-1, 3)
    w_sq = [w**2 for w in weights]
    aa_mat = a_mat[..., None] * a_mat[..., None, :]
    ab_mat = a_mat[..., None] * b_vec[..., None, :]
    lhs = splat_to_grid(idxs, w_sq, torch.zeros(grid_shape + [4, 4], device=device), aa_mat)
    lhs = lhs + lstsq_eps * torch.eye(4, device=device)
    rhs = splat_to_grid(idxs, w_sq, torch.zeros(grid_shape + [4, 3], device=device), ab_mat)
    affine_grid = _lstsq(lhs, rhs)
    affine_im = slice_from_grid(idxs, weights, affine_grid).reshape(tuple(im.shape[:-1]) + (4, 3))
    im_clc = (im1[..., None, :] @ affine_im)[..., 0, :]
    return torch.clamp(im_clc, 0, 1)


def compute_shift_invariant_metric(im0, im1, metric_fn, reduction, search_radii,
                                   window_halfwidth, boundary="reflect"):
    """Per pixel, `metric_fn(shifted im0, im1)` at the integer shift (di,
    dj) of the search window whose metric, box-pooled over
    2 * window_halfwidth + 1 (zero padding counted), is the best
    (``"argmax"`` or ``"argmin"``; a tie goes to the later shift); returns
    (that metric, di, dj)."""
    im0 = torch.as_tensor(im0, dtype=torch.float32)
    im1 = torch.as_tensor(im1, dtype=torch.float32)
    if im0.dim() != 3 or im0.shape[2] != 3 or im0.shape != im1.shape:
        raise ValueError(f"Invalid input image shapes {tuple(im0.shape)}, {tuple(im1.shape)}")
    if reduction not in ("argmax", "argmin"):
        raise ValueError("reduction must be 'argmax' or 'argmin'")
    i_radius, j_radius = search_radii
    im0_pad = F.pad(im0.permute(2, 0, 1)[None], (j_radius, j_radius, i_radius, i_radius),
                    mode=boundary)[0].permute(1, 2, 0)
    k = 2 * window_halfwidth + 1

    opt_metric_pooled = opt_metric = opt_di = opt_dj = None
    for di in range(-i_radius, i_radius + 1):
        for dj in range(-j_radius, j_radius + 1):
            rolled = torch.roll(torch.roll(im0_pad, -di, 0), -dj, 1)
            cropped = rolled[i_radius:rolled.shape[0] - i_radius,
                             j_radius:rolled.shape[1] - j_radius]
            metric = metric_fn(cropped, im1)
            pooled = F.avg_pool2d(metric[None, None], k, stride=1, padding=window_halfwidth,
                                  count_include_pad=True)[0, 0]
            if opt_metric_pooled is None:
                opt_metric_pooled, opt_metric = pooled, metric
                opt_di = torch.full_like(metric, di, dtype=torch.int32)
                opt_dj = torch.full_like(metric, dj, dtype=torch.int32)
                continue
            take = (pooled >= opt_metric_pooled if reduction == "argmax"
                    else pooled <= opt_metric_pooled)
            opt_metric_pooled = torch.where(take, pooled, opt_metric_pooled)
            opt_metric = torch.where(take, metric, opt_metric)
            opt_di = torch.where(take, torch.full_like(opt_di, di), opt_di)
            opt_dj = torch.where(take, torch.full_like(opt_dj, dj), opt_dj)
    return opt_metric, opt_di, opt_dj


def shift_invariant_mse(img0, img1, *args):
    """(mean of the per-pixel best-shift MSE, di, dj)."""
    def err_fn(x, y):
        return torch.mean((x - y) ** 2, dim=-1)

    opt, di, dj = compute_shift_invariant_metric(img0, img1, err_fn, "argmin", *args)
    return torch.mean(opt), di, dj


def shift_invariant_ssim(img0, img1, *args):
    """(mean of the per-pixel best-shift SSIM, di, dj); each SSIM map is
    taken on the images reflect-padded by its window's half-width, 5."""
    pad = 5

    def pad_fn(z):
        return F.pad(z.permute(2, 0, 1)[None], (pad, pad, pad, pad),
                     mode="reflect")[0].permute(1, 2, 0)

    def score_fn(x, y):
        return torch.mean(ssim(pad_fn(x), pad_fn(y), return_map=True), dim=-1)

    opt, di, dj = compute_shift_invariant_metric(img0, img1, score_fn, "argmax", *args)
    return torch.mean(opt[pad:-pad, pad:-pad]), di, dj
