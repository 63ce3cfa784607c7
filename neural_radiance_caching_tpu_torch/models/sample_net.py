"""Learned sample-offset network (counterpart of ``models/sample_net.py``).

A small MLP that, given the proposal sampler's final sample points along a
ray, predicts an eased distance offset along the ray and a 3D point offset
(each gated by a learned sigma); ``ProposalVolumeSampler`` adds the
``point_offset`` to its last level's means under ``use_sample_network``.
Its layers are ``layer.{i}`` (JAX's ``layer_{i}``) and ``output_layer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models.layers import Configurable, Dense
from neural_radiance_caching_tpu_torch.ops import coord
from neural_radiance_caching_tpu_torch.ops import math as math_utils


def ease_activation(window_frac, act, val=1.0):
    """Linearly ease the activation's output toward `val` over window_frac."""

    def new_act(train_frac, x):
        if not window_frac:
            return act(x)
        w = min(max(train_frac / window_frac, 0.0), 1.0)
        return act(x) * w + val * (1.0 - w)

    return new_act


def pluecker(origins, directions):
    """Pluecker ray coordinates [direction, moment]."""
    directions = math_utils.normalize(directions)
    moment = torch.linalg.cross(origins, directions, dim=-1)
    return torch.cat([directions, moment], dim=-1)


def intersect_sphere(origins, directions, radius):
    """Both parametric intersections of rays with a centered sphere."""
    o, d = origins, directions
    a = (d * d).sum(-1)
    b = 2 * (o * d).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    sq = torch.sqrt(disc + 1e-8)
    zero = torch.zeros_like(disc)
    t1 = torch.where(disc <= 0, zero, (-b + sq) / (2 * a))
    t2 = torch.where(disc <= 0, zero, (-b - sq) / (2 * a))
    return t1, t2


_OUTPUTS = {"z_vals": 1, "point_offset": 3, "sigma": 1, "point_sigma": 1}


@gin.configurable
class SampleNetwork(Configurable, nn.Module):
    """Predicts eased distance and point offsets for proposal samples."""

    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    window_frac = 0
    num_views = 1
    use_viewdirs = True
    use_time = False
    mlp_width = 256
    mlp_depth = 4
    contract_fn = staticmethod(lambda x: x)
    inv_contract_fn = staticmethod(lambda x: x)

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        in_dim = 3 + 3 * 4 * 2
        if self.use_viewdirs:
            in_dim += 3 + 3 * 2 * 2
        if self.use_time:
            in_dim += 1 + 6 * 2
        widths = [in_dim] + [self.mlp_width] * self.mlp_depth
        self.layer = nn.ModuleList(Dense(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.output_layer = Dense(widths[-1], sum(_OUTPUTS.values()))

    def _aabb(self, like):
        bounds = torch.as_tensor(self.aabb, dtype=like.dtype, device=like.device)
        return bounds[:3], bounds[3:]

    def normalize_inputs(self, points, origins, viewdirs):
        aabb_min, aabb_max = self._aabb(points)
        points = (points - aabb_min) / (aabb_max - aabb_min) * 4.0 - 2.0
        origins = (origins - aabb_min) / (aabb_max - aabb_min) * 4.0 - 2.0
        rays_norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
        viewdirs = math_utils.normalize(viewdirs / (aabb_max - aabb_min)) * rays_norm
        return points, origins, viewdirs

    def unnormalize_points(self, points):
        aabb_min, aabb_max = self._aabb(points)
        return (points / 4.0 + 0.5) * (aabb_max - aabb_min) + aabb_min

    def get_network_input(self, points, viewdirs, times):
        net_input = coord.pos_enc(points, 0, 4, True)
        if self.use_viewdirs:
            net_input = torch.cat([net_input, coord.pos_enc(viewdirs, 0, 2, True)], dim=-1)
        if self.use_time:
            net_input = torch.cat([net_input, coord.pos_enc(times, 0, 6, True)], dim=-1)
        return net_input.detach()

    def forward(self, train_frac, points_uncontract, origins_uncontract, viewdirs, t_idx):
        activations = [
            lambda tf, x: torch.tanh(x * 0.25) * 0.125,
            lambda tf, x: torch.tanh(x * 1.0) * 0.25,
            ease_activation(self.window_frac, lambda x: torch.sigmoid(x + 3.0), 1.0),
            ease_activation(self.window_frac, lambda x: torch.sigmoid(x + 3.0), 1.0),
        ]
        points_original = points_uncontract
        points_n, origins_n, viewdirs_n = self.normalize_inputs(
            points_uncontract, origins_uncontract, viewdirs)
        shape = points_n.shape
        points_n = points_n.reshape(-1, 3)
        origins_n = origins_n.reshape(-1, 3)
        viewdirs_n = viewdirs_n.reshape(-1, 3)
        if self.use_time:
            times = (t_idx / self.num_views) * 2 - 1
            times = torch.as_tensor(times, dtype=torch.float32, device=points_n.device)
            times = times.reshape(-1)[..., None].expand(points_n.shape[:1] + (1,))
        else:
            times = torch.zeros_like(points_n[..., :1])

        rays_norm = torch.linalg.norm(viewdirs_n, dim=-1, keepdim=True)
        dists_uncontract = (torch.linalg.norm(points_n - origins_n, dim=-1, keepdim=True)
                            / torch.clamp(rays_norm, min=1e-12))
        dists_contract = self.contract_fn(dists_uncontract)
        points_contract = self.contract_fn(points_n)

        x = self.get_network_input(points_contract, viewdirs_n, times)
        for layer in self.layer:
            x = F.relu(layer(x))
        x = self.output_layer(x)
        out = {}
        for (name, _), act, part in zip(_OUTPUTS.items(), activations,
                                         torch.split(x, list(_OUTPUTS.values()), dim=-1)):
            out[name] = act(train_frac, part)

        # Eased distance offset along the ray, then an eased 3D point offset.
        dist_offset = out["z_vals"] * (1.0 - out["sigma"])
        new_dists = self.inv_contract_fn(dists_contract + dist_offset)
        new_points = origins_n + viewdirs_n * new_dists
        new_points_contract = self.contract_fn(new_points) + out["point_offset"] * (
            1.0 - out["point_sigma"])
        new_points = self.unnormalize_points(self.inv_contract_fn(new_points_contract)).reshape(
            shape)
        return dict(
            point_offset=points_original - new_points,
            point_offset_contract=(points_contract - new_points_contract).reshape(shape),
        )
