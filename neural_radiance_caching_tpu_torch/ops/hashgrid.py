"""Multiresolution hash-grid encoding, Instant-NGP style (counterpart of
``ops/hashgrid.py``).

Forward: per-tap corners, weights and row indices for every level at once,
then two gathers (dense pool, stacked hash tables), in plain torch. Backward:
``_GridEncode``, an autograd Function whose table gradient is one weighted
scatter-add over all levels (``ops/scatter_cuda.py``: a CUDA kernel for CUDA
tensors, its plain ``index_add_`` version for CPU tensors). The layout of that
scatter follows the JAX encoder: below ``PLANES_MIN_POINTS`` sampled points
the leveled kernel (taps-fastest update rows), at secondary-ray fan-outs the
planes kernel (point-minor tap planes); ``use_planes_layout`` decides. With
``scatter_dedup`` the leveled backward first sums each run of equal rows
along the point axis onto the run's last update and scatters only those
(``_dedup_weighted_scatter``, the skip-zero-weight kernel instance).

``_GridEncode``'s backward is first-order only (``once_differentiable``: its
table gradient comes from a kernel launch with no autograd history), so a
second backward through it raises. A caller that differentiates the
encoding twice (the analytic density normals) asks for the plain encoder,
``multires_grid_encode(..., plain=True)``, whose autograd is second-order.

Semantics match the JAX encoder bit for bit where they are integer: the
spatial hash wraps int32 corners to uint32 and multiplies (computed here in
int64 masked to 32 bits), simplex ranks break ties with the same `>`/`>=`
pattern, and dense levels zero the taps whose corner falls outside the grid.
"""

from __future__ import annotations

import math as pymath
from typing import Optional, Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from neural_radiance_caching_tpu_torch.ops import math as nrc_math

_PI2 = 19349663
_PI3 = 83492791
_U32 = 0xFFFFFFFF

# The eight corner offsets of a voxel (floor/ceil enumeration, x major).
_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.int32)


def compute_grid_sizes(min_grid_size, max_grid_size, scale_supersample):
    """Geometric level sizes N_min..N_max."""
    desired = 1 + scale_supersample * np.log2(max_grid_size / min_grid_size)
    num_scales = int(np.round(desired))
    if np.abs(desired - num_scales) > 1e-4:
        raise ValueError(
            f"(min={min_grid_size}, max={max_grid_size}, "
            f"supersample={scale_supersample}) yields non-integer scale count {desired}."
        )
    return np.round(np.geomspace(min_grid_size, max_grid_size, num_scales)).astype(np.int32)


def _corner_coords_and_weights(x, grid_sizes, interpolation="trilinear"):
    """Voxel corners and interpolation weights for all levels at once.

    Args:
      x: [..., 3] coordinates in [0, 1]^3 (outside is legal: hash levels wrap,
        dense levels zero out).
      grid_sizes: static [L] level resolutions.
      interpolation: 'trilinear' (8 corners) or 'simplex' (tetrahedral, 4).

    Returns:
      corners: [..., L, U, 3] int32 lattice coordinates.
      weights: [..., L, U] interpolation weights (sum to 1 in range).
    """
    sizes = torch.as_tensor(np.asarray(grid_sizes), dtype=x.dtype, device=x.device)
    pos = x[..., None, :] * sizes[:, None] - 0.5  # [..., L, 3]
    floor = torch.floor(pos)
    frac = pos - floor
    floor_i = floor.to(torch.int32)

    if interpolation == "trilinear":
        offs = torch.as_tensor(_CORNERS, device=x.device)  # [8, 3]
        corners = floor_i[..., None, :] + offs
        sel = offs.to(x.dtype)
        w = sel * frac[..., None, :] + (1 - sel) * (1 - frac[..., None, :])
        return corners, w[..., 0] * w[..., 1] * w[..., 2]

    if interpolation != "simplex":
        raise ValueError(f"Unknown interpolation {interpolation!r}")

    # Tetrahedral: walk from the base corner along axes in decreasing-frac
    # order. Corner k includes axis i iff rank(frac_i) < k; ties break by axis
    # index so the ranks are always a permutation of (0, 1, 2).
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    i32 = torch.int32
    r_x = (fy > fx).to(i32) + (fz > fx).to(i32)
    r_y = (fx >= fy).to(i32) + (fz > fy).to(i32)
    r_z = (fx >= fz).to(i32) + (fy >= fz).to(i32)
    ranks = torch.stack([r_x, r_y, r_z], dim=-1)  # [..., L, 3]
    k = torch.arange(4, dtype=i32, device=x.device)
    offsets = (ranks[..., None, :] < k[:, None]).to(i32)  # [..., L, 4, 3]
    corners = floor_i[..., None, :] + offsets

    g1 = torch.maximum(torch.maximum(fx, fy), fz)
    g3 = torch.minimum(torch.minimum(fx, fy), fz)
    g2 = fx + fy + fz - g1 - g3
    weights = torch.stack([1.0 - g1, g1 - g2, g2 - g3, g3], dim=-1)
    return corners, weights


def _hash_indices(corners, table_size):
    """Instant-NGP spatial hash: int32 corners wrap to uint32, then
    x ^ (y * 19349663) ^ (z * 83492791) mod T, all modulo 2^32."""
    c = corners.to(torch.int64) & _U32
    h = c[..., 0] ^ ((c[..., 1] * _PI2) & _U32) ^ ((c[..., 2] * _PI3) & _U32)
    return (h % table_size).to(torch.int32)


def _dense_indices(corners, grid_size):
    """Flat [x*S*S + y*S + z] index plus an in-range validity mask."""
    valid = torch.all((corners >= 0) & (corners < grid_size), dim=-1)
    c = torch.clamp(corners, 0, grid_size - 1)
    idx = (c[..., 0] * grid_size + c[..., 1]) * grid_size + c[..., 2]
    return idx, valid


def _tap_rows_and_weights(x, x_scale, grid_sizes, table_size, num_dense, interpolation):
    """Per-tap local rows and effective weights for every level.

    Args:
      x: [P, 3] points in [0, 1]^3; x_scale: [P, 1] footprint or None.

    Returns:
      rows: [P, L, U] int32 rows local to each level's table (dense levels:
        row in that level's S^3 block; hash levels: row in its T-row table).
      weights: [P, L, U] interpolation weight x dense validity x mip weight.
    """
    grid_sizes = np.asarray(grid_sizes)
    corners, weights = _corner_coords_and_weights(x, grid_sizes, interpolation)
    if x_scale is not None:
        sizes = torch.as_tensor(grid_sizes, dtype=x.dtype, device=x.device)
        mip_w = nrc_math.approx_erf(1 / (pymath.sqrt(8.0) * (x_scale * sizes)))  # [P, L]
        weights = weights * mip_w[..., None]
    rows, valid = [], []
    for li in range(len(grid_sizes)):
        c = corners[:, li]
        if li < num_dense:
            idx, ok = _dense_indices(c, int(grid_sizes[li]))
            rows.append(idx)
            valid.append(ok)
        else:
            rows.append(_hash_indices(c, table_size))
    rows = torch.stack(rows, dim=1).to(torch.int32)
    if num_dense:
        dense_valid = torch.stack(valid, dim=1).to(weights.dtype)
        weights = torch.cat([weights[:, :num_dense] * dense_valid, weights[:, num_dense:]], dim=1)
    return rows, weights


def _gather_features(rows, weights, hash_tables, dense_pool, table_size, dense_offsets):
    """sum_u w[p, l, u] * table_l[rows[p, l, u]] -> [P, L, F]."""
    num_dense = len(dense_offsets)
    parts = []
    if num_dense:
        offs = torch.as_tensor(dense_offsets, dtype=torch.int64, device=rows.device)
        d_rows = rows[:, :num_dense].to(torch.int64) + offs[:, None]
        parts.append(dense_pool[d_rows])  # [P, Ld, U, F]
    num_hash = rows.shape[1] - num_dense
    if num_hash:
        level_off = torch.arange(num_hash, dtype=torch.int64, device=rows.device) * table_size
        h_rows = rows[:, num_dense:].to(torch.int64) + level_off[:, None]
        parts.append(hash_tables.reshape(-1, hash_tables.shape[-1])[h_rows])
    feats = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return (feats * weights[..., None].to(feats.dtype)).sum(dim=-2)


def _reduce_multisamples(f_plf, batch_shape, m, multisample_reduce):
    """[P*M, L, F] per-(point, multisample) features -> [..., L*F], the mean
    over multisamples (the one reduction the cache slice uses)."""
    if multisample_reduce != "mean":
        raise NotImplementedError(f"multisample_reduce={multisample_reduce!r} is not ported yet")
    num_levels, nf = f_plf.shape[-2:]
    f = f_plf.reshape(batch_shape + (m, num_levels, nf))
    return f.mean(dim=-3).reshape(batch_shape + (num_levels * nf,))


def _multires_grid_encode_torch(x, hash_tables, dense_pool, *, grid_sizes, table_size,
                                dense_offsets, x_scale=None, multisample_reduce="mean",
                                interpolation="trilinear"):
    """Plain-torch encoder (counterpart of ``_multires_grid_encode_xla``);
    its autograd is the reference gradient of the kernel backward.

    Args:
      x: [..., M, 3] coordinates in [0, 1]^3, with a multisample axis M.
      hash_tables: [L_hash, T, F] stacked hash-level tables (or None).
      dense_pool: [sum(S^3), F] flat dense-level pool (or None).
      grid_sizes: per-level resolutions, dense levels first.
      dense_offsets: flat offsets of each dense level in dense_pool; its
        length is the number of dense levels.
      x_scale: optional [..., M, 1] isotropic footprint; features are
        down-weighted by the erf mip weight.
    """
    batch_shape, m = tuple(x.shape[:-2]), x.shape[-2]
    xs = None if x_scale is None else x_scale.reshape(-1, 1)
    rows, weights = _tap_rows_and_weights(
        x.reshape(-1, 3), xs, grid_sizes, table_size, len(dense_offsets), interpolation)
    f = _gather_features(rows, weights, hash_tables, dense_pool, table_size, dense_offsets)
    return _reduce_multisamples(f, batch_shape, m, multisample_reduce)


# Point count (points x multisamples) from which the 'mean' backward takes the
# plane-layout scatter, as the JAX encoder's threshold of the same value.
PLANES_MIN_POINTS = 1 << 20


def use_planes_layout(num_points, multisample_reduce):
    """True when a backward over `num_points` sampled points (points x
    multisamples) scatters from tap planes rather than taps-fastest rows."""
    return multisample_reduce == "mean" and num_points >= PLANES_MIN_POINTS


# Run-dedup of the leveled backward: runs of equal rows along the point axis
# are force-broken every 2**DEDUP_SCAN_STEPS points, so a capped
# Hillis-Steele scan of that many steps sums every run exactly.
DEDUP_SCAN_STEPS = 6


def _shift_points(x, shift):
    """x [L, P, ...] moved `shift` points later along axis 1, zero-filled."""
    pad = [0, 0] * (x.dim() - 2) + [shift, 0]
    return torch.nn.functional.pad(x, pad)[:, : x.shape[1]]


def _dedup_weighted_scatter(idx_l, w_l, ct_l, *, num_rows, features, corners, scatter_fn):
    """Run-deduplicated leveled scatter (counterpart of the JAX function of
    the same name).

    idx_l/w_l: [L, P*U] (corners fastest); ct_l: [L, P, F]. The update
    stream of ``dedup_runs`` goes through ``scatter_fn`` with
    ``skip_zero_w``: one row per update (corners = 1), the updates of weight
    0 skipped. The sums equal the direct scatter's up to float32 association
    order.
    """
    keep, rows = dedup_runs(idx_l, w_l, ct_l, corners=corners)
    return scatter_fn(idx_l, keep, rows, num_rows=num_rows, features=features, corners=1,
                      skip_zero_w=True)


def dedup_runs(idx_l, w_l, ct_l, *, corners):
    """The run-deduplicated update stream of a leveled scatter.

    Consecutive points that share a tap's row (same cell, same tap slot)
    have their w * ct contributions summed onto the run's last point with a
    capped segmented scan. Returns (keep [L, P*U] float32, 1 at run ends and
    0 elsewhere; rows [L, P*U, F], each run end's row carrying its run's
    sum).
    """
    levels, p, features = ct_l.shape
    idx3 = idx_l.reshape(levels, p, corners)
    v = w_l.reshape(levels, p, corners)[..., None] * ct_l[:, :, None, :]  # [L, P, U, F]
    same = torch.zeros((levels, p, corners), dtype=torch.bool, device=idx_l.device)
    same[:, 1:] = idx3[:, 1:] == idx3[:, :-1]
    # A run break every 2**steps points keeps the capped scan exact however
    # long the true runs are (the broken tail scatters separately).
    pos_break = torch.arange(p, device=idx_l.device) % (1 << DEDUP_SCAN_STEPS) != 0
    same &= pos_break[None, :, None]

    acc = v
    connected = same[..., None].to(v.dtype)  # [L, P, U, 1]
    for k in range(DEDUP_SCAN_STEPS):
        acc = acc + connected * _shift_points(acc, 1 << k)
        connected = connected * _shift_points(connected, 1 << k)
    # Run ends carry the run's sum; everything else is skipped.
    is_end = torch.ones_like(same)
    is_end[:, :-1] = ~same[:, 1:]
    return (is_end.reshape(levels, p * corners).to(torch.float32),
            acc.reshape(levels, p * corners, features))


def _dense_level_heights(dense_offsets, total):
    """Per-level row counts of the flat dense pool."""
    return [
        (dense_offsets[li + 1] if li + 1 < len(dense_offsets) else total) - dense_offsets[li]
        for li in range(len(dense_offsets))
    ]


def _split_levels(out, num_dense, heights, table_size):
    """[L, rows, F] per-level accumulators -> (dense pool grad, hash tables grad)."""
    d_grad = torch.cat([out[li, :h] for li, h in enumerate(heights)]) if num_dense else None
    h_grad = out[num_dense:, :table_size] if out.shape[0] > num_dense else None
    return d_grad, h_grad


def _scatter_shape(rows, dense_pool, table_size, dense_offsets):
    """(num_rows, per-level dense heights) of the one scatter over all levels.

    Dense levels use their local rows in full-height accumulators and are
    sliced back to their true heights afterwards; hash levels keep T rows.
    """
    num_dense = len(dense_offsets)
    heights = _dense_level_heights(dense_offsets, dense_pool.shape[0]) if num_dense else []
    num_rows = max(heights + ([table_size] if rows.shape[1] > num_dense else []))
    return num_rows, heights


class _GridEncode(torch.autograd.Function):
    """Gather forward; weighted-scatter table backward (counterpart of the
    JAX ``custom_vjp`` built by ``_make_encode_vjp``)."""

    @staticmethod
    def forward(ctx, x, hash_tables, dense_pool, x_scale, statics):
        (grid_sizes, table_size, dense_offsets, multisample_reduce, interpolation,
         _, _, _) = statics
        batch_shape, m = tuple(x.shape[:-2]), x.shape[-2]
        xs = None if x_scale is None else x_scale.reshape(-1, 1)
        rows, weights = _tap_rows_and_weights(
            x.reshape(-1, 3), xs, grid_sizes, table_size, len(dense_offsets), interpolation)
        f = _gather_features(rows, weights, hash_tables, dense_pool, table_size, dense_offsets)
        ctx.save_for_backward(x, x_scale, rows, weights, hash_tables, dense_pool)
        ctx.statics = statics
        ctx.shape_info = (batch_shape, m)
        return _reduce_multisamples(f, batch_shape, m, multisample_reduce)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, x_scale, rows, weights, hash_tables, dense_pool = ctx.saved_tensors
        (grid_sizes, table_size, dense_offsets, multisample_reduce, interpolation,
         scatter_fn, planes_fn, scatter_dedup) = ctx.statics
        batch_shape, m = ctx.shape_info
        num_levels = len(grid_sizes)

        d_grad = h_grad = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # One scatter over all levels (one kernel launch per backward).
            # The mean over multisamples hands each (point, multisample) 1/m
            # of the point's cotangent.
            nf = ct.shape[-1] // num_levels
            corners = rows.shape[2]
            num_rows, heights = _scatter_shape(rows, dense_pool, table_size, dense_offsets)
            w = weights.to(torch.float32)
            if use_planes_layout(rows.shape[0], multisample_reduce):
                # Tap planes [L, U, points] and cotangent planes [L, F, points],
                # one column per (point, multisample), m-minor as the
                # x.reshape(-1, 3) flattening of the forward.
                ct_planes = (ct.reshape(-1, num_levels, nf) / m).permute(1, 2, 0)
                if m > 1:
                    ct_planes = ct_planes.repeat_interleave(m, dim=-1)
                out = planes_fn(
                    rows.permute(1, 2, 0).contiguous(), w.permute(1, 2, 0).contiguous(),
                    ct_planes.to(torch.float32).contiguous(),
                    num_rows=num_rows, features=nf, corners=corners)
            else:
                # Update rows [L, points * U] (taps fastest) and cotangent
                # rows [L, points, F].
                ct_pm = (ct.reshape(batch_shape + (1, num_levels, nf)) / m).expand(
                    batch_shape + (m, num_levels, nf)).reshape(-1, num_levels, nf)
                args = (rows.permute(1, 0, 2).reshape(num_levels, -1).contiguous(),
                        w.permute(1, 0, 2).reshape(num_levels, -1).contiguous(),
                        ct_pm.permute(1, 0, 2).to(torch.float32).contiguous())
                if scatter_dedup and corners > 1:
                    out = _dedup_weighted_scatter(*args, num_rows=num_rows, features=nf,
                                                  corners=corners, scatter_fn=scatter_fn)
                else:
                    out = scatter_fn(*args, num_rows=num_rows, features=nf, corners=corners)
            d_grad, h_grad = _split_levels(out, len(dense_offsets), heights, table_size)

        dx = dxs = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[3]:
            # Input gradients: differentiate the plain forward with the tables
            # held constant (no scatter involved).
            with torch.enable_grad():
                xg = x.detach().requires_grad_(ctx.needs_input_grad[0])
                xsg = None if x_scale is None else x_scale.detach().requires_grad_(
                    ctx.needs_input_grad[3])
                out = _multires_grid_encode_torch(
                    xg, None if hash_tables is None else hash_tables.detach(),
                    None if dense_pool is None else dense_pool.detach(),
                    grid_sizes=grid_sizes, table_size=table_size, dense_offsets=dense_offsets,
                    x_scale=xsg, multisample_reduce=multisample_reduce,
                    interpolation=interpolation)
                wrt = [t for t in (xg, xsg) if t is not None and t.requires_grad]
                grads = iter(torch.autograd.grad(out, wrt, ct, allow_unused=True))
                dx = next(grads) if xg.requires_grad else None
                dxs = next(grads) if xsg is not None and xsg.requires_grad else None
        return (dx, h_grad if ctx.needs_input_grad[1] else None,
                d_grad if ctx.needs_input_grad[2] else None, dxs, None)


def multires_grid_encode(
    x,
    hash_tables,
    dense_pool,
    *,
    grid_sizes: Sequence[int],
    table_size: int,
    dense_offsets: Sequence[int],
    x_scale=None,
    multisample_reduce: Optional[str] = "mean",
    interpolation: str = "trilinear",
    scatter_fn=None,
    planes_scatter_fn=None,
    scatter_dedup: bool = False,
    plain: bool = False,
):
    """Public encoder: gather forward, weighted-scatter table backward.

    See _multires_grid_encode_torch for argument semantics. ``scatter_fn``
    and ``planes_scatter_fn`` pick the leveled and the plane-layout
    table-gradient scatter for this call; the defaults,
    ``scatter_cuda.scatter_add_weighted_leveled`` and
    ``scatter_cuda.scatter_add_weighted_planes``, launch the CUDA kernels on
    CUDA tensors and run their plain versions on CPU tensors.
    ``scatter_dedup`` runs the leveled backward through the run-dedup
    (``_dedup_weighted_scatter``, ``scatter_fn`` with ``skip_zero_w=True``);
    as in the JAX encoder it applies below ``PLANES_MIN_POINTS`` and with
    more than one tap per point. ``plain`` takes the plain-torch encoder
    instead, whose autograd (gather backward, no kernel) is second-order.
    """
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    if plain:
        return _multires_grid_encode_torch(
            x, hash_tables, dense_pool, grid_sizes=tuple(int(s) for s in grid_sizes),
            table_size=int(table_size), dense_offsets=tuple(int(o) for o in dense_offsets),
            x_scale=x_scale, multisample_reduce=multisample_reduce, interpolation=interpolation)

    if scatter_fn is None:
        scatter_fn = scatter_cuda.scatter_add_weighted_leveled
    if planes_scatter_fn is None:
        planes_scatter_fn = scatter_cuda.scatter_add_weighted_planes
    grid_sizes = tuple(int(s) for s in np.asarray(grid_sizes).tolist())
    dense_offsets = tuple(int(o) for o in dense_offsets)
    statics = (grid_sizes, int(table_size), dense_offsets, multisample_reduce,
               interpolation, scatter_fn, planes_scatter_fn, bool(scatter_dedup))
    return _GridEncode.apply(x, hash_tables, dense_pool, x_scale, statics)
