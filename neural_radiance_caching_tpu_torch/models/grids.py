"""Grid-backed spatial feature encoders (counterpart of ``models/grids.py``).

``HashEncoding``, the multiresolution hash encoding: one stacked
``hash_levels`` [L_hash, T, F] parameter for all hash levels and one flat
``dense_levels`` [sum(S^3), F] parameter for all dense levels. The
parameters are always the full pyramid; a ``max_levels`` clamp slices them
for the call, so the clamped levels get zero gradients. Its multisample
reduction follows ``per_level_fn`` (the mean, the concatenation, or none),
and its per-level transforms (``append_scale``'s scale feature, the feature
filter) and ``feature_aggregator="sum"`` act on the level-major output.

``FactoredGrid`` (TensoRF's vector-matrix factors, interpolated as JAX's
``map_coordinates(order=1)``: a corner outside the grid adds zero) and
``Triplane`` (three feature planes, bilinear with clamped edges) gather in
plain torch; no scatter kernel is involved.
"""

from __future__ import annotations

import itertools
import math as pymath
from typing import Optional

import numpy as np
import torch
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.ops import hashgrid, math


@gin.configurable
class HashEncoding(Configurable, nn.Module):
    """Multiresolution grid/hash encoding (Instant NGP)."""

    hash_map_size = 2**19  # T
    num_features = 2  # F
    scale_supersample = 2.0
    min_grid_size = 16
    max_grid_size = 2048
    hash_init_range = 1e-4
    precondition_scaling = 10.0
    bbox_scaling = 2.0
    append_scale = False
    resample_op_mode = None
    interpolation = "trilinear"
    feature_aggregator = "concatenate"
    # Run-dedup of the table-gradient scatter (``hashgrid.multires_grid_encode``'s
    # ``scatter_dedup``): the counterpart of the JAX package's process-global
    # ``set_scatter_dedup``, here a field of the grid.
    scatter_dedup = False

    def __init__(self, **kwargs):
        nn.Module.__init__(self)
        self._set_fields(kwargs)
        if self.feature_aggregator not in ("concatenate", "sum"):
            raise ValueError(f"feature_aggregator={self.feature_aggregator!r}: the JAX "
                             "package defines 'concatenate' and 'sum'")
        sizes = self.grid_sizes.astype(np.int64)
        num_dense = self.num_dense_levels
        maxval = self.hash_init_range / self.precondition_scaling
        if num_dense:
            total = int((sizes[:num_dense] ** 3).sum())
            self.dense_levels = nn.Parameter(
                torch.empty(total, self.num_features).uniform_(-maxval, maxval))
        else:
            self.dense_levels = None
        num_hash = len(sizes) - num_dense
        if num_hash:
            self.hash_levels = nn.Parameter(
                torch.empty(num_hash, self.hash_map_size, self.num_features).uniform_(
                    -maxval, maxval))
        else:
            self.hash_levels = None

    @property
    def grid_sizes(self):
        return hashgrid.compute_grid_sizes(
            self.min_grid_size, self.max_grid_size, self.scale_supersample)

    @property
    def bbox(self):
        bbox = self.bbox_scaling
        if isinstance(bbox, (int, float)):
            bbox = ((-bbox,) * 3, (bbox,) * 3)
        return np.array(bbox)

    @property
    def num_dense_levels(self):
        sizes = self.grid_sizes.astype(np.int64)
        return int((sizes**3 <= self.hash_map_size).sum())

    @property
    def dense_offsets(self):
        if self.num_dense_levels == 0:
            return ()
        sizes = self.grid_sizes.astype(np.int64)[: self.num_dense_levels]
        return tuple(np.concatenate([[0], np.cumsum(sizes**3)[:-1]]).astype(int).tolist())

    @property
    def output_dim(self):
        """The width of a call with the mean (or no) multisample reduction."""
        width = self.num_features + int(bool(self.append_scale))
        if self.feature_aggregator == "sum":
            return width
        return len(self.grid_sizes) * width

    def forward(self, x, *, x_scale=None, per_level_fn=None, train=True, train_frac=1.0,
                feature_filter=None, feature_filter_size=None,
                max_levels: Optional[int] = None, plain_encoder=False):
        """Encode [..., M, 3] world points into [..., L*F] features.

        per_level_fn: ``math.average_across_multisamples`` (the mean over M),
        ``math.concat_across_multisamples`` ([..., L*M*F]), or None or an
        identity function (every point keeps its own feature).
        feature_filter: [..., 1, 1] (or any [..., k] that averages to one
        value per output row) weight of the levels finer than
        feature_filter_size.
        max_levels: clamp the pyramid to its coarsest K levels for this call;
        the finer levels' features are zeros, so the output width is fixed.
        plain_encoder: encode through the plain-torch encoder (second-order
        autograd, no scatter kernel) for this call.
        """
        del train, train_frac
        grid_sizes = self.grid_sizes
        full_num_levels = len(grid_sizes)
        if max_levels is not None and max_levels < full_num_levels:
            grid_sizes = grid_sizes[:max_levels]
        bbox = self.bbox
        lo = torch.as_tensor(bbox[0], dtype=x.dtype, device=x.device)
        span = torch.as_tensor(bbox[1] - bbox[0], dtype=x.dtype, device=x.device)
        x = (x - lo) / span

        if x_scale is not None:
            sizes = np.diff(bbox, axis=0)[0]
            if np.any(np.abs(sizes[0] - sizes[1:]) > np.finfo(np.float32).eps):
                raise ValueError("x_scale must be None when bbox is not square.")
            x_scale = x_scale / float(sizes[0])
        if self.append_scale and x_scale is None:
            raise ValueError("append_scale=True requires an x_scale input.")

        if per_level_fn is None:
            reduce = None
        elif per_level_fn is math.average_across_multisamples:
            reduce = "mean"
        elif per_level_fn is math.concat_across_multisamples:
            reduce = "concat"
        else:
            # An identity function (the reflectance grids' lambda x: x), found
            # by probing it as JAX does.
            probe = torch.ones((2, 3))
            if tuple(per_level_fn(probe).shape) != tuple(probe.shape):
                raise NotImplementedError(f"Unsupported per_level_fn {per_level_fn}")
            reduce = None

        num_dense_full = self.num_dense_levels
        num_dense = min(num_dense_full, len(grid_sizes))
        num_hash = len(grid_sizes) - num_dense
        dense_pool = None
        if num_dense:
            total = int((grid_sizes[:num_dense].astype(np.int64) ** 3).sum())
            dense_pool = self.dense_levels[:total]
        hash_tables = self.hash_levels[:num_hash] if num_hash else None

        encode_kwargs = dict(
            grid_sizes=tuple(int(s) for s in grid_sizes), table_size=self.hash_map_size,
            dense_offsets=self.dense_offsets[:num_dense], interpolation=self.interpolation,
            scatter_dedup=self.scatter_dedup, plain=plain_encoder)
        if reduce is None:
            # Every input point keeps its own feature: a singleton multisample
            # axis, whose mean is the identity.
            features = hashgrid.multires_grid_encode(
                x[..., None, :], hash_tables, dense_pool,
                x_scale=None if x_scale is None else x_scale[..., None, :],
                multisample_reduce="mean", **encode_kwargs)
        else:
            features = hashgrid.multires_grid_encode(
                x, hash_tables, dense_pool, x_scale=x_scale, multisample_reduce=reduce,
                **encode_kwargs)
            if reduce == "concat":
                features = features.reshape(features.shape[:-2] + (-1,))

        num_levels = len(grid_sizes)
        if self.append_scale or feature_filter is not None:
            lead = features.shape[:-1]
            f_lvl = features.reshape(lead + (num_levels, -1))
            if self.append_scale:
                f_lvl = self._append_scale(f_lvl, x, x_scale, grid_sizes, num_dense,
                                           dense_pool, hash_tables, reduce)
            if feature_filter is not None:
                # Zero the levels finer than feature_filter_size outside the
                # filter (one weight per output row).
                gate = torch.as_tensor(grid_sizes > (feature_filter_size or 0),
                                       device=f_lvl.device).reshape(num_levels, 1)
                filt = torch.as_tensor(feature_filter, device=f_lvl.device).to(f_lvl.dtype)
                filt = filt.reshape(lead + (-1,)).mean(dim=-1)[..., None, None]
                f_lvl = f_lvl * torch.where(gate, filt, torch.ones_like(filt))
            features = f_lvl.reshape(lead + (-1,))

        if self.feature_aggregator == "sum":
            features = features.reshape(features.shape[:-1] + (num_levels, -1)).sum(dim=-2)
        elif num_levels < full_num_levels:
            per_level_width = features.shape[-1] // num_levels
            pad = (full_num_levels - num_levels) * per_level_width
            features = torch.nn.functional.pad(features, (0, pad))
        return features * self.precondition_scaling

    def _append_scale(self, f_lvl, x, x_scale, grid_sizes, num_dense, dense_pool, hash_tables,
                      reduce):
        """Each level's features [..., L, F'] with the scale feature 2 w - 1
        appended, w the level's mip weight, times the level's feature RMS
        (detached); under concat, once per multisample before the flatten."""
        sizes = torch.as_tensor(grid_sizes.astype(np.float32), dtype=f_lvl.dtype,
                                device=f_lvl.device)
        weighting = math.approx_erf(1.0 / (pymath.sqrt(8.0) * (x_scale * sizes)))
        if reduce == "mean":
            weighting = weighting.mean(dim=-2)
        maxval = self.hash_init_range / self.precondition_scaling
        level_rms = []
        for li in range(len(grid_sizes)):
            if li < num_dense:
                start = self.dense_offsets[li]
                vals = dense_pool[start:start + int(grid_sizes.astype(np.int64)[li] ** 3)]
            else:
                vals = hash_tables[li - num_dense]
            level_rms.append(torch.sqrt(maxval**2 + torch.mean(vals.detach() ** 2)))
        rms = torch.stack(level_rms)
        if reduce == "concat":
            m = x.shape[-2]
            f_lvl = f_lvl.reshape(f_lvl.shape[:-1] + (m, -1))
            f_scale = (2.0 * weighting.movedim(-2, -1) - 1.0) * rms[:, None]
            return torch.cat([f_lvl, f_scale[..., None]], dim=-1).reshape(
                f_lvl.shape[:-2] + (-1,))
        f_scale = (2.0 * weighting - 1.0) * rms
        return torch.cat([f_lvl, f_scale[..., None]], dim=-1)


def _frames(bbox_scaling):
    """The three axis frames (rolled identities) over the bounding box, as
    index permutations and one float32 factor: frame i's row r reads
    coordinate (r - i) mod 3."""
    perm = [[(r - i) % 3 for r in range(3)] for i in range(3)]
    return perm, float(np.float32(1.0 / bbox_scaling))


def _map_coordinates_linear(grid, coords):
    """JAX's map_coordinates(grid, coords, order=1) with mode 'constant' and
    cval 0 over the trailing axes of `grid` [B, *S] (one grid per leading
    row) at `coords` [B, D, ...] (D = len(S)): the corners of each point,
    the out-of-range ones adding zero, summed in JAX's order."""
    dims = grid.shape[1:]
    nodes = []
    for d, size in enumerate(dims):
        c = coords[:, d]
        lower = torch.floor(c)
        upper_w = c - lower
        idx = lower.to(torch.int64)
        nodes.append([(idx, 1 - upper_w, size), (idx + 1, upper_w, size)])
    flat = grid.reshape(grid.shape[0], -1)
    out = None
    for items in itertools.product(*nodes):
        lin = None
        valid = None
        weight = None
        for (idx, w, size) in items:
            ok = (idx >= 0) & (idx < size)
            valid = ok if valid is None else valid & ok
            weight = w if weight is None else weight * w
            ci = idx.clamp(0, size - 1)
            lin = ci if lin is None else lin * size + ci
        vals = torch.gather(flat, 1, lin.reshape(lin.shape[0], -1)).reshape(lin.shape)
        contrib = weight * torch.where(valid, vals, torch.zeros_like(vals))
        out = contrib if out is None else out + contrib
    return out


@gin.configurable
class FactoredGrid(Configurable, nn.Module):
    """Low-rank factored 3D grid (TensoRF): per component and axis frame, a
    line (``grid_features_1d`` [C, 3, G]) times a plane (``grid_features_2d``
    [C, 3, G, G]), projected by ``grid_features_appearance`` [3 C, F]."""

    grid_size = 300
    num_features = 28
    num_components = 64
    feature_init_scale = 0.1
    bbox_scaling = 2.0
    reduction = "sum"  # declared in JAX, read by nothing there

    def __init__(self, **kwargs):
        nn.Module.__init__(self)
        self._set_fields(kwargs)
        c, g = self.num_components, self.grid_size
        init = lambda *shape: nn.Parameter(torch.randn(shape) * self.feature_init_scale)
        self.grid_features_1d = init(c, 3, g)
        self.grid_features_2d = init(c, 3, g, g)
        self.grid_features_appearance = init(c * 3, self.num_features)

    @property
    def bbox(self):
        b = self.bbox_scaling
        return np.array(((-b,) * 3, (b,) * 3))

    @property
    def output_dim(self):
        return self.num_features

    def forward(self, x, *, x_scale=None, per_level_fn=None, train=True, train_frac=1.0):
        del train, train_frac
        if x_scale is not None:
            raise ValueError("x_scale should be None for FactoredGrid.")
        perm, inv_b = _frames(self.bbox_scaling)
        xf = torch.stack([x[..., p] for p in perm], dim=-2) * inv_b  # [..., frame, 3]
        xf = (xf + 1.0) / 2.0 * self.grid_size
        xf = xf.movedim((-2, -1), (0, 1))  # [frame, 3, ...]
        lead = xf.shape[2:]
        c = self.num_components

        def interp(grid, coords):
            # grid [C, 3, *S], coords [3, D, ...] -> [C, 3, ...]
            d = coords.shape[1]
            g = grid.reshape((c * 3,) + grid.shape[2:])
            cc = coords.reshape(1, 3, d, -1).expand(c, 3, d, coords[0, 0].numel())
            out = _map_coordinates_linear(g, cc.reshape(c * 3, d, -1))
            return out.reshape((c, 3) + tuple(lead))

        g3 = interp(self.grid_features_1d, xf[:, :1]) * interp(self.grid_features_2d,
                                                               xf[:, 1:3])
        g3 = g3.reshape((-1,) + tuple(lead)).movedim(0, -1)  # [..., 3 C]
        features = torch.matmul(g3, self.grid_features_appearance)
        if per_level_fn is not None:
            features = per_level_fn(features)
        return features


@gin.configurable
class Triplane(Configurable, nn.Module):
    """Triplane feature grid (EG3D): three [G, G, F] planes
    (``triplane_grid_features_2d``), each sampled bilinearly with clamped
    edges, summed (or averaged, ``reduction="mean"``)."""

    grid_size = 512
    num_features = 48
    feature_init_scale = 0.1
    bbox_scaling = 2.0
    reduction = "sum"

    def __init__(self, **kwargs):
        nn.Module.__init__(self)
        self._set_fields(kwargs)
        g = self.grid_size
        self.triplane_grid_features_2d = nn.Parameter(
            torch.randn(3, g, g, self.num_features) * self.feature_init_scale)

    @property
    def output_dim(self):
        return self.num_features

    def forward(self, x, *, x_scale=None, per_level_fn=None, train=True, train_frac=1.0):
        del train, train_frac
        if x_scale is not None:
            raise ValueError("x_scale should be None for Triplane.")
        perm, inv_b = _frames(self.bbox_scaling)
        # Rows 1 and 2 of each frame: the plane's (x, y) coordinates.
        xf = torch.stack([x[..., p[1:3]] for p in perm], dim=0) * inv_b  # [3, ..., 2]
        c = torch.clamp((xf + 1.0) / 2.0 * self.grid_size, 0, self.grid_size - 1)
        c0f = torch.floor(c)
        frac = c - c0f
        c0 = c0f.to(torch.int64)
        c1 = torch.clamp(c0 + 1, max=self.grid_size - 1)
        g, nf = self.grid_size, self.num_features
        planes = self.triplane_grid_features_2d.reshape(3, g * g, nf)

        def gather(cx, cy):
            lin = (cy * g + cx).reshape(3, -1, 1).expand(3, cx[0].numel(), nf)
            return torch.gather(planes, 1, lin).reshape(cx.shape + (nf,))

        f00 = gather(c0[..., 0], c0[..., 1])
        f01 = gather(c0[..., 0], c1[..., 1])
        f10 = gather(c1[..., 0], c0[..., 1])
        f11 = gather(c1[..., 0], c1[..., 1])
        wx, wy = frac[..., 0:1], frac[..., 1:2]
        gathered = (f00 * (1 - wx) * (1 - wy) + f10 * wx * (1 - wy) + f01 * (1 - wx) * wy
                    + f11 * wx * wy)
        features = gathered.sum(dim=0) if self.reduction == "sum" else gathered.mean(dim=0)
        if per_level_fn is not None:
            features = per_level_fn(features)
        return features


GRID_REPRESENTATION_BY_NAME = {
    "ngp": HashEncoding,
    "hash": HashEncoding,
    "triplane": Triplane,
    "tensorf": FactoredGrid,
}
