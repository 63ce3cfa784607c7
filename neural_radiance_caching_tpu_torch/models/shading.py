"""Shared shader base: appearance features from density features (counterpart
of ``models/shading.py``). The shader's own appearance grid is not on the
cache slice and is not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.models.layers import Configurable, SkipMLP
from neural_radiance_caching_tpu_torch.utils import torchutil


class BaseShader(Configurable, nn.Module):
    """Base class for the shaders (radiance cache, surface light field)."""

    net_activation = staticmethod(F.relu)
    net_depth = 8
    net_width = 256
    bottleneck_width = 256
    bottleneck_noise = 0.0
    skip_layer = 4
    num_rgb_channels = 3
    rgb_premultiplier = 1.0
    rgb_activation = staticmethod(torch.sigmoid)
    rgb_bias = 0.0
    warp_fn = None  # read only with the appearance grid
    use_density_feature = True
    use_grid = False
    normals_target = "normals_to_use"
    use_bf16_compute = False

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_grid=False)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.use_bf16_compute else None

    def _build_trunk(self, density_feature_dim):
        """The appearance trunk `layers` over the density feature; returns its
        output width."""
        in_dim = density_feature_dim if self.use_density_feature else 0
        if in_dim == 0:
            raise NotImplementedError("shaders without the density feature are not ported yet")
        self.layers = SkipMLP(in_dim, [self.net_width] * self.net_depth, self.skip_layer,
                              self.net_activation, self.compute_dtype)
        return self.layers.out_dim

    def predict_appearance_feature(self, sampler_results, train=True, train_frac=1.0,
                                   is_secondary=False, **kwargs):
        """Per-sample appearance feature from the density feature."""
        del train, train_frac, is_secondary, kwargs
        return self.layers(sampler_results["feature"])

    def forward(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                is_secondary=None, shading_only=False, **kwargs):
        key, rng = torchutil.random_split(rng)
        shading_results = self.predict_appearance(
            rng=key, rays=rays, sampler_results=sampler_results, train_frac=train_frac,
            train=train, is_secondary=is_secondary, **kwargs)
        if shading_only:
            return shading_results
        return dict(**shading_results,
                    **{k: v for k, v in sampler_results.items() if k not in shading_results})
