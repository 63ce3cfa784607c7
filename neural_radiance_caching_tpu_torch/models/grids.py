"""Multiresolution hash encoding module (counterpart of ``HashEncoding`` in
``models/grids.py``).

One stacked ``hash_levels`` [L_hash, T, F] parameter for all hash levels and
one flat ``dense_levels`` [sum(S^3), F] parameter for all dense levels. The
parameters are always the full pyramid; a ``max_levels`` clamp slices them
for the call, so the clamped levels get zero gradients.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.ops import hashgrid, math


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
        self._require(append_scale=False, feature_aggregator="concatenate")
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
        return len(self.grid_sizes) * self.num_features

    def forward(self, x, *, x_scale=None, per_level_fn=None, train=True, train_frac=1.0,
                feature_filter=None, feature_filter_size=None,
                max_levels: Optional[int] = None):
        """Encode [..., M, 3] world points into [..., L*F] features.

        max_levels: clamp the pyramid to its coarsest K levels for this call;
        the finer levels' features are zeros, so the output width is fixed.
        """
        del train, train_frac, feature_filter_size
        if feature_filter is not None:
            raise NotImplementedError("feature_filter is not ported yet")
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

        if per_level_fn is None:
            x = x[..., None, :]
            x_scale = None if x_scale is None else x_scale[..., None, :]
        elif per_level_fn is not math.average_across_multisamples:
            raise NotImplementedError(f"per_level_fn {per_level_fn} is not ported yet")

        num_dense_full = self.num_dense_levels
        num_dense = min(num_dense_full, len(grid_sizes))
        num_hash = len(grid_sizes) - num_dense
        dense_pool = None
        if num_dense:
            total = int((grid_sizes[:num_dense].astype(np.int64) ** 3).sum())
            dense_pool = self.dense_levels[:total]
        hash_tables = self.hash_levels[:num_hash] if num_hash else None

        features = hashgrid.multires_grid_encode(
            x, hash_tables, dense_pool,
            grid_sizes=tuple(int(s) for s in grid_sizes),
            table_size=self.hash_map_size,
            dense_offsets=self.dense_offsets[:num_dense],
            x_scale=x_scale,
            interpolation=self.interpolation,
            scatter_dedup=self.scatter_dedup,
        )
        if len(grid_sizes) < full_num_levels:
            per_level_width = features.shape[-1] // len(grid_sizes)
            pad = (full_num_levels - len(grid_sizes)) * per_level_width
            features = torch.nn.functional.pad(features, (0, pad))
        return features * self.precondition_scaling


GRID_REPRESENTATION_BY_NAME = {"ngp": HashEncoding, "hash": HashEncoding}
