"""Hierarchical proposal sampling, mip-NeRF 360 style (counterpart of
``models/sampler.py``).

Each level dilates the previous histogram, anneals its logits, draws new
intervals by inverse-CDF sampling, warps s -> t, lifts them to Gaussians,
evaluates the level's DensityMLP and composites alpha weights. Ported for
primary and secondary rays, with the identity ray warp or a ``raydist_fn``
given as ``(fn, fn_inv, kwargs)`` (the power ladder of the gin files).
Secondary rays that carry the normal of the surface they leave (shadow
rays) start off it; the density-radius filter of their last level is
ported. The mesh shortcut, the sample network, a ray warp without its
inverse and the other density filters are not ported yet.
Levels before the last can run without a graph (``proposal_grad``), where
no loss reads them.
"""

from __future__ import annotations

import functools
import math as pymath

import torch
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import geometry
from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.ops import coord, math, render, stepfun
from neural_radiance_caching_tpu_torch.utils import torchutil


@gin.configurable
class ProposalVolumeSampler(Configurable, nn.Module, unported=dict(
        use_uniform_radius=False, use_normal_radius=False,
        use_far_field_radius=False, use_vertical_filter=False, use_horizontal_filter=False,
        use_backwards_filter=False, use_uniform_radius_secondary_only=True,
        normalize_uniform_weights=False, uniform_radius=float("inf"),
        normal_radius=float("inf"), far_field_radius=float("inf"), vertical_fov=pymath.pi,
        horizontal_fov=pymath.pi,
        disable_integration=False, near_anneal_rate=None, near_anneal_init=0.95,
        normalize_weights=False, use_sample_network=False)):
    """Multi-level proposal sampler producing per-level ray results."""

    # Declared by the JAX sampler and read by nothing there (its MLPs take
    # their own grid_representation).
    sampling_anneal_blur_start = 1.0
    sampling_anneal_blur_stop = 0.05
    sampling_anneal_rate = 0.025
    grid_representation = "ngp"

    sampling_strategy = ((0, None, 64), (0, None, 64), (1, None, 32))
    mlp_params_per_level = ({}, {})
    grid_params_per_level = ()
    stop_level_grad = True
    anneal_clip = 1.0
    anneal_end = 1.0
    anneal_slope = 10.0
    ray_shape = "cone"
    single_jitter = True
    dilation_multiplier = 0.5
    dilation_bias = 0.0025
    resample_padding = 0.0
    opaque_background = False
    raydist_fn = None
    # Secondary rays: zero density beyond this radius at the last level.
    use_density_radius = False
    density_radius = float("inf")

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        if self.raydist_fn is not None and not isinstance(self.raydist_fn, tuple):
            raise NotImplementedError("a raydist_fn without its inverse is not ported yet")
        grid_params = self.grid_params_per_level or tuple(None for _ in self.mlp_params_per_level)
        self.mlps = nn.ModuleList([
            geometry.DensityMLP(
                config=config,
                grid_params=grid_params[i] if i < len(grid_params) else None,
                **dict(params),
            )
            for i, params in enumerate(self.mlp_params_per_level)
        ])

    def _ray_warps(self, rays, use_raydist_fn):
        if not use_raydist_fn or self.raydist_fn is None:
            return coord.construct_ray_warps(None, rays.near, rays.far)
        fn, fn_inv, kwargs = self.raydist_fn
        return coord.construct_ray_warps(functools.partial(fn, **kwargs), rays.near, rays.far,
                                         fn_inv=functools.partial(fn_inv, **kwargs))

    def _anneal(self, train_frac):
        """Proposal-logit sharpening over training (Schlick's bias curve)."""
        if self.anneal_slope <= 0:
            return self.anneal_clip
        x = train_frac / self.anneal_end
        s = self.anneal_slope
        return float(min(max((s * x) / ((s - 1) * x + 1), 0.0), self.anneal_clip))

    def forward(self, rng, rays, train_frac=1.0, train=True, stopgrad_proposal=False,
                stopgrad_weights=False, stopgrad_samples=False, sampling_strategy=None,
                use_raydist_fn=True, proposal_grad=True, density_only=False, **render_kwargs):
        """The per-level ray results. proposal_grad=False evaluates every level
        but the last without a graph where their samples reach the next
        level detached (``stop_level_grad``): then only a loss on their own
        weights (the interlevel loss) could read one. density_only: the
        MLPs skip their density normals (a caller that reads the weights
        alone)."""
        is_secondary = render_kwargs.get("is_secondary", False)
        if is_secondary and rays.normals is not None:
            # Push the near bound off the surface the ray leaves, along its normal.
            dotprod = math.dot(rays.viewdirs, rays.normals.detach())
            offset = torch.clamp(
                self.config.shadow_normal_eps_dot_min / torch.clamp(dotprod, min=1e-5),
                rays.near, rays.far)
            offset = torch.where(dotprod > 0, offset, rays.near).detach()
            near = torch.maximum(rays.near, offset.reshape(rays.near.shape))
            rays = rays.replace(near=torch.clamp(near, torch.full_like(near, 1e-5),
                                                 rays.far - 1e-5))
        if not train and is_secondary:
            # Secondary rays of an eval render sample deterministically seeded,
            # on the caller's generator device (so a CPU generator gives a
            # run on the card the same draws as one on the CPU).
            device = rays.origins.device if rng is None else rng.device
            rng = torch.Generator(device=device).manual_seed(0)
        if sampling_strategy is None:
            sampling_strategy = self.sampling_strategy
        max_mlp = max(level[0] for level in sampling_strategy)
        if max_mlp >= len(self.mlps):
            raise ValueError(
                f"sampling_strategy {tuple(sampling_strategy)} indexes MLP {max_mlp} but "
                f"mlp_params_per_level only defines {len(self.mlps)} MLP(s)")

        _, s_to_t = self._ray_warps(rays, use_raydist_fn)
        init_s_near, init_s_far = 0.0, 1.0
        sdist = torch.cat([torch.full_like(rays.near, init_s_near),
                           torch.full_like(rays.far, init_s_far)], dim=-1)
        resample_weights = torch.ones_like(rays.near)
        ray_history = []
        prod_num_samples = 1

        for i_level, (i_mlp, _, num_samples) in enumerate(sampling_strategy):
            mlp = self.mlps[i_mlp]
            dilation = (self.dilation_bias + self.dilation_multiplier
                        * (init_s_far - init_s_near) / prod_num_samples)
            use_dilation = self.dilation_bias > 0 or self.dilation_multiplier > 0
            if prod_num_samples > 1 and use_dilation:
                sdist, resample_weights = stepfun.max_dilate_weights(
                    sdist, resample_weights, dilation, domain=(init_s_near, init_s_far),
                    renormalize=True)
                sdist = sdist[..., 1:-1]
                resample_weights = resample_weights[..., 1:-1]
            prod_num_samples *= num_samples

            logits_resample = self._anneal(train_frac) * math.safe_log(
                resample_weights + self.resample_padding)
            key, rng = torchutil.random_split(rng)
            sdist = stepfun.sample_intervals(
                key, sdist, logits_resample, num_samples, single_jitter=self.single_jitter,
                domain=(init_s_near, init_s_far))
            if self.stop_level_grad:
                sdist = sdist.detach()

            tdist = s_to_t(sdist)
            gaussians = render.cast_rays(
                tdist, rays.origins, rays.directions, rays.radii, self.ray_shape, diag=False)

            is_last = i_level == len(sampling_strategy) - 1
            key, rng = torchutil.random_split(rng)
            keep_graph = proposal_grad or is_last or not self.stop_level_grad
            with torch.set_grad_enabled(torch.is_grad_enabled() and keep_graph):
                ray_results = mlp(rng=key, rays=rays, gaussians=gaussians, tdist=tdist,
                                  train_frac=train_frac, train=train, density_only=density_only,
                                  **render_kwargs)

            means = gaussians[0]
            if self.use_density_radius and is_secondary and is_last:
                ray_results["density"] = torch.where(
                    torch.linalg.norm(means, dim=-1) > self.density_radius,
                    torch.zeros_like(ray_results["density"]), ray_results["density"])
            ray_results["points"] = means
            ray_results["means"] = means
            ray_results["covs"] = gaussians[1]

            # Rectified normals: flip sign so surfaces face the camera.
            rectified = {}
            for k, v in ray_results.items():
                if k.startswith("normals") and v is not None:
                    p = torch.sum(v * rays.viewdirs[..., None, :], dim=-1, keepdim=True)
                    rectified[k + "_rectified"] = v * torch.where(p > 0, -1.0, 1.0)
            ray_results.update(rectified)

            weights, alphas, trans = render.compute_alpha_weights(
                ray_results["density"], tdist, rays.directions,
                opaque_background=self.opaque_background)
            resample_weights = weights
            ray_results["tdist"] = tdist
            ray_results["sdist"] = sdist
            if stopgrad_weights:
                weights, alphas, trans = weights.detach(), alphas.detach(), trans.detach()
            ray_results["weights"] = weights
            ray_results["alphas"] = alphas
            ray_results["trans"] = trans

            if (stopgrad_proposal and not is_last) or stopgrad_samples:
                ray_results = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                               for k, v in ray_results.items()}
            ray_history.append(ray_results)

        for results in ray_history:
            results["lossmult"] = rays.lossmult
        return ray_history
