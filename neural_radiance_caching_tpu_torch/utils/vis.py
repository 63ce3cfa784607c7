"""Rendering visualization suite (the port's own numpy copy of
``utils/vis.py``): a dict of [H, W, 3] float buffers in [0, 1] keyed by the
names the trainer logs (color, color_cache, depth_mean, normals,
material_* ...), tolerating missing rendering keys (passes differ per
stage), and the PNG writers. It needs no plotting or image library: the
turbo colormap is its polynomial fit and the PNGs are written with zlib.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_F32_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=_F32_EPS):
    """Linear -> sRGB transfer on host arrays."""
    linear = np.asarray(linear)
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * np.maximum(eps, linear) ** (5 / 12) - 11) / 200
    return np.where(linear <= 0.0031308, srgb0, srgb1)


def colorize(x, percentile=99.0, pos_color=(1, 0, 0), neg_color=(0, 0, 1),
             bg_color=(1, 1, 1), xnp=np):
    """Map +x to pos_color, -x to neg_color, x==0 to bg_color."""
    max_val = xnp.percentile(xnp.abs(x), percentile)
    x_norm = x / (max_val + 1e-12)
    x_pos = xnp.clip(x_norm, 0, 1)
    x_neg = xnp.clip(-x_norm, 0, 1)
    x_zero = xnp.maximum(0, 1 - xnp.abs(x_norm))
    return (
        x_pos[..., None] * xnp.array(pos_color)
        + x_neg[..., None] * xnp.array(neg_color)
        + x_zero[..., None] * xnp.array(bg_color)
    )


def weighted_percentile(x, w, ps, assume_sorted=False, xnp=np):
    """Weighted percentile(s) of a vector."""
    x = x.reshape([-1])
    w = w.reshape([-1])
    if not assume_sorted:
        sortidx = xnp.argsort(x)
        x, w = x[sortidx], w[sortidx]
    acc_w = xnp.cumsum(w)
    return xnp.interp(xnp.array(ps) * (acc_w[-1] / 100), acc_w, x)


def sinebow(h, xnp=np):
    """Cyclic uniform colormap."""
    f = lambda x: xnp.sin(xnp.pi * x) ** 2
    return xnp.stack([f(3 / 6 - h), f(5 / 6 - h), f(7 / 6 - h)], -1)


def matte(vis, acc, xnp=np):
    """Composite over white where nothing accumulated."""
    return vis + (1.0 - acc[..., None])


def visualize_cmap(value, weight, colormap, lo=None, hi=None, percentile=99.0,
                   curve_fn=lambda x: x, modulus=None, xnp=np):
    """Colormap a scalar buffer, auto-ranged by weighted percentiles."""
    w = weight
    if np.ndim(w) < np.ndim(value):
        w = xnp.broadcast_to(xnp.asarray(w)[..., None], np.shape(value))
    lo_auto, hi_auto = weighted_percentile(
        value, w, [50 - percentile / 2, 50 + percentile / 2], xnp=xnp
    )
    eps = xnp.finfo(xnp.float32).eps
    lo = lo if lo is not None else (lo_auto - eps)
    hi = hi if hi is not None else (hi_auto + eps)
    value, lo, hi = [curve_fn(x) for x in (value, lo, hi)]
    if modulus:
        value = xnp.mod(value, modulus) / modulus
    else:
        value = xnp.clip((value - xnp.minimum(lo, hi)) / xnp.abs(hi - lo), 0, 1)
    value = xnp.nan_to_num(value)
    if colormap:
        return colormap(value)[..., :3]
    if value.shape[-1] != 3:
        raise ValueError(f"value must have 3 channels but has {value.shape[-1]}")
    return value


# The turbo colormap as its published degree-5 polynomial fit per channel
# (no plotting library); a channel differs from the lookup table's by up to
# 0.13, at the ends of the range. The depth buffers are drawn with it.
_TURBO_COEFFS = np.array([
    [0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943],
    [0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604],
    [0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973],
], np.float32)


def _turbo():
    """x in [0, 1] -> RGBA, as a colormap is called."""

    def cmap(x):
        x = np.clip(np.asarray(x, np.float32), 0, 1)[..., None]
        rgb = sum(c * x**i for i, c in enumerate(_TURBO_COEFFS.T))
        return np.concatenate([np.clip(rgb, 0, 1), np.ones_like(x)], axis=-1)

    return cmap


def _srgb(x):
    return np.clip(linear_to_srgb(np.nan_to_num(np.asarray(x))), 0, 1)


def _ones_like_rgb(rgb):
    return np.ones_like(rgb)


def visualize_suite(rendering: Dict[str, Any], config=None, vis_material=False,
                    vis_secondary=False) -> Dict[str, np.ndarray]:
    """Steady-state vis buffers (vis.py:319-523)."""
    del vis_secondary
    depth_curve_fn = lambda x: -np.log(x + np.finfo(np.float32).eps)
    rgb = _srgb(rendering["rgb"])
    ones = _ones_like_rgb(rgb)
    vis: Dict[str, np.ndarray] = {"color": rgb}

    def put_srgb(out_key, key, scale=1.0):
        if key in rendering and rendering[key] is not None:
            v = np.asarray(rendering[key], np.float32)
            if v.ndim == rgb.ndim - 1:
                v = v[..., None]
            vis[out_key] = _srgb(v * np.ones_like(rgb[..., :1]) * scale
                                 if v.shape[-1] in (1, 3) else v)

    put_srgb("color_cache", "cache_rgb")
    if "cache_rgb" in rendering:
        m = float(np.max(np.asarray(rendering["cache_rgb"])) + 1e-12)
        vis["color_cache0"] = _srgb(np.asarray(rendering["cache_rgb"]) / m)
    for key in (
        "cache_diffuse_rgb", "cache_specular_rgb", "cache_direct_rgb",
        "cache_indirect_rgb", "cache_ambient_rgb", "cache_irradiance_rgb",
        "cache_albedo_rgb", "cache_direct_diffuse_rgb",
        "cache_direct_specular_rgb", "cache_indirect_diffuse_rgb",
        "cache_indirect_specular_rgb", "cache_ambient_diffuse_rgb",
        "cache_ambient_specular_rgb", "cache_env_map_rgb", "cache_incoming_rgb",
    ):
        put_srgb(key.replace("rgb", "color"), key)
    for key in ("cache_occ", "cache_indirect_occ", "lossmult"):
        if key in rendering and rendering[key] is not None:
            vis[key] = np.clip(
                np.nan_to_num(np.asarray(rendering[key], np.float32)) * ones, 0, 1
            )

    # MC-noise buffer: per-pixel variance over render repeats, scaled by
    # Config.var_scale / img_scale (reference vis.py:328).
    if "rgb_variance" in rendering and rendering["rgb_variance"] is not None:
        var_scale = getattr(config, "var_scale", 1.0) if config is not None else 1.0
        img_scale = getattr(config, "img_scale", 1.0) if config is not None else 1.0
        vis["color_variance"] = _srgb(
            np.abs(np.asarray(rendering["rgb_variance"], np.float32))
            * (var_scale / img_scale)
        )

    # Depth.
    if "acc" in rendering and "distance_mean" in rendering:
        acc = np.nan_to_num(np.asarray(rendering["acc"], np.float32))
        distance_mean = np.asarray(rendering["distance_mean"], np.float32)
        distance_median = np.asarray(
            rendering.get("distance_median", distance_mean), np.float32
        )
        acc = np.where(np.isnan(distance_mean), np.zeros_like(acc), acc)
        vis["acc"] = np.clip(acc[..., None] * ones, 0, 1)
        p = 99.0
        lo, hi = weighted_percentile(
            distance_median, acc, [50 - p / 2, 50 + p / 2]
        )
        cmap = _turbo()
        vis["depth_mean"] = visualize_cmap(
            distance_mean, acc, cmap, lo=lo, hi=hi, curve_fn=depth_curve_fn
        )
        vis["depth_median"] = visualize_cmap(
            distance_median, acc, cmap, lo=lo, hi=hi, curve_fn=depth_curve_fn
        )
        if "distance_percentile_5" in rendering:
            d5 = np.asarray(rendering["distance_percentile_5"], np.float32)
            d95 = np.asarray(rendering["distance_percentile_95"], np.float32)
            vis["depth_triplet"] = visualize_cmap(
                np.stack(
                    [2 * distance_median - d5, distance_median, d95], axis=-1
                ),
                acc, None,
                curve_fn=lambda x: np.log(x + np.finfo(np.float32).eps),
            )
    else:
        acc = np.ones_like(rgb[..., 0])

    if vis_material:
        for key in (
            "material_albedo", "material_roughness", "material_F_0",
            "material_metalness", "material_diffuseness", "material_mirrorness",
        ):
            if key in rendering and rendering[key] is not None:
                v = np.nan_to_num(np.asarray(rendering[key], np.float32)) * ones
                if "albedo" in key:
                    v = v ** (1.0 / 2.2)
                vis[key] = np.clip(matte(v, acc), 0, 1)
        for key in (
            "diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb",
            "direct_diffuse_rgb", "direct_specular_rgb",
            "indirect_diffuse_rgb", "indirect_specular_rgb",
            "lighting_irradiance", "irradiance_cache",
        ):
            put_srgb("material_" + key.replace("rgb", "color"), key)
        for key in ("occ", "indirect_occ"):
            if key in rendering and rendering[key] is not None:
                vis["material_" + key] = np.clip(
                    np.nan_to_num(np.asarray(rendering[key], np.float32)) * ones,
                    0, 1,
                )

    # Normals.
    for key, val in rendering.items():
        if key.startswith("normals") and val is not None:
            v = np.nan_to_num(np.asarray(val, np.float32))
            if v.shape[-1] == 3:
                vis[key] = np.clip(matte(v / 2.0 + 0.5, acc), 0, 1)
    return vis


def finite(x):
    """`np.nan_to_num(x)` in float32; an array that is finite already (as
    every render output is: the renderer zeroes NaNs on the device) is
    returned without the copy."""
    x = np.asarray(x, np.float32)
    return x if np.isfinite(x).all() else np.nan_to_num(x)


def visualize_transient_suite(rendering: Dict[str, Any], config=None,
                              vis_material=False, vis_secondary=False
                              ) -> Dict[str, np.ndarray]:
    """Transient vis: integrate over time then reuse the steady suite
    (vis.py:526-742). Only an [H, W, bins, C] radiance buffer is summed
    over its bins; a steady [H, W, C] one (the cache's direct light) passes
    as it is, and the other per-bin buffers (lossmult, the vignette, equal
    in every bin) are shown at their first bin. The JAX package sums the
    axis before the last of every radiance buffer of 3 or more dimensions
    and passes the per-bin lossmult whole, so its suite raises a ValueError
    at a broadcast that follows."""
    img_scale = getattr(config, "img_scale", 1.0) if config is not None else 1.0

    def integrate(v):
        v = finite(v)
        if v.ndim == 4:  # [H, W, bins, C]
            v = v.sum(-2)
        return np.clip(v / img_scale, 0, 1)

    integrated = {}
    for k, v in rendering.items():
        if v is None or not hasattr(v, "shape"):
            continue
        if "transient" in k or k in ("rgb", "cache_rgb", "direct_rgb",
                                     "indirect_rgb", "cache_direct_rgb",
                                     "cache_indirect_rgb"):
            integrated[k] = integrate(v)
        elif np.ndim(v) == 4:
            integrated[k] = np.asarray(v)[..., 0, :]
        else:
            integrated[k] = np.asarray(v)
    vis = visualize_suite(integrated, config, vis_material=vis_material)
    for k in ("transient_indirect", "cache_transient_indirect"):
        if k in rendering and rendering[k] is not None:
            vis[k.replace("transient_indirect", "indirect_integrated")] = _srgb(
                integrate(rendering[k])
            )
    return vis


def _u8(img):
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = arr.repeat(3, -1)
    return (np.clip(np.nan_to_num(arr), 0, 1) * 255).astype(np.uint8)


def _write_png(path, rgb):
    """An 8-bit RGB PNG of an [H, W, 3] uint8 array (zlib, no image
    library)."""
    import struct
    import zlib

    h, w, _ = rgb.shape

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = b"".join(b"\x00" + np.ascontiguousarray(row).tobytes() for row in rgb)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def save_img_u8(img, path):
    """Write one [H, W, 3] float buffer in [0, 1] as an 8-bit PNG."""
    _write_png(path, _u8(img))


def save_vis_suite(vis: Dict[str, np.ndarray], out_dir: str, step: int):
    """Write each buffer as a PNG under out_dir/<key>/<step>.png."""
    import os

    for key, buf in vis.items():
        d = os.path.join(out_dir, key)
        os.makedirs(d, exist_ok=True)
        _write_png(os.path.join(d, f"{step:06d}.png"), _u8(buf))
