"""Model composition: sampler -> shader -> integrator (counterpart of
``NeRFModel`` in ``models/nerf_model.py``).

Ported: the primary-ray cache path without resampling, volume control
variates, env maps or the surface-light-field memory; those raise.
"""

from __future__ import annotations

from torch import nn

from neural_radiance_caching_tpu_torch.models import integrator as integrator_lib
from neural_radiance_caching_tpu_torch.models import nerf_shader, sampler as sampler_lib
from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.utils import torchutil


class NeRFModel(Configurable, nn.Module):
    """Steady-state radiance cache: proposal sampler + NeRFMLP + integrator."""

    use_env_map = False
    use_surface_light_field = False
    resample = False
    resample_render = False
    train_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    render_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    sampler_params = None
    shader_params = None
    integrator_params = None
    extra_model_params = None

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_env_map=False, use_surface_light_field=False, resample=False,
                      resample_render=False)
        if config.volume_variate or config.volume_variate_secondary:
            raise NotImplementedError("volume control variates are not ported yet")
        self.sampler = sampler_lib.ProposalVolumeSampler(
            config=config, **dict(self.sampler_params or {}),
            **dict(self.extra_model_params or {}))
        self.shader = nerf_shader.NeRFMLP(
            config=config, density_feature_dim=self.sampler.mlps[-1].feature_dim,
            **dict(self.shader_params or {}))
        self.integrator = integrator_lib.VolumeIntegrator(
            config=config, **dict(self.integrator_params or {}))

    def get_sampling_strategy(self, train, sampling_strategy):
        if sampling_strategy is not None:
            return sampling_strategy
        return self.train_sampling_strategy if train else self.render_sampling_strategy

    def forward(self, rng, rays, train_frac=1.0, train=True, sampling_strategy=None,
                is_secondary=False, **render_kwargs):
        """Render a ray batch; returns {"main": per-stage results, "render": rgb etc.}."""
        if is_secondary:
            raise NotImplementedError("secondary-ray queries are not ported yet")
        key, rng = torchutil.random_split(rng)
        sampler_results = self.sampler(
            rng=key, rays=rays, train_frac=train_frac, train=train,
            sampling_strategy=self.get_sampling_strategy(train, sampling_strategy),
            **render_kwargs)

        filtered = dict(sampler_results[-1])
        filtered["weights_no_filter"] = filtered["weights"]

        key, rng = torchutil.random_split(rng)
        shader_results = self.shader(
            rng=key, rays=rays, sampler_results=filtered, filtered_sampler_results=filtered,
            train_frac=train_frac, train=train, is_secondary=False, **render_kwargs)
        shader_results.setdefault("weights_no_filter", shader_results["weights"])
        key, rng = torchutil.random_split(rng)
        integrator_results = self.integrator(
            rng=key, rays=rays, shader_results=shader_results, bg_intensity_range=None,
            train_frac=train_frac, train=train, is_secondary=False, **render_kwargs)

        main = dict(
            loss_weight=1.0, sampler=sampler_results, filtered_sampler_inds=None,
            shader=shader_results, geometry=sampler_results[-1], integrator=integrator_results,
        )
        return {"main": main, "render": integrator_results}
