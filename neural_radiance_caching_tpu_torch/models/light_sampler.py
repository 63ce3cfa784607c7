"""Learnable vMF light sampler (counterpart of ``LightMLP`` in
``models/light_sampler.py``).

A von Mises-Fisher mixture over incoming-light directions at each surface
point, predicted from the sampler's own hash grid; the material shader uses
it to importance-sample secondary rays. Multi-illumination outputs and the
pulsed light source (``LightSourceMap``) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from neural_radiance_caching_tpu_torch.models import shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, softplus
from neural_radiance_caching_tpu_torch.utils import torchutil


class LightMLP(shading.BaseShader):
    """vMF mixture light sampler over an NGP grid."""

    num_components = 64
    vmf_scale = 20.0
    random_seed = 1
    vmf_bias = None
    vmf_activation = None
    num_light_features = 64
    use_illumination_feature = False
    multiple_illumination_outputs = True

    def __init__(self, config=None, **kwargs):
        super().__init__(config, **kwargs)
        if config.multi_illumination:
            raise NotImplementedError("multi-illumination light samplers are not ported yet")
        feature_dim = self._build_trunk(0)
        self.output_layer = Dense(feature_dim, self.num_components * 5, self.compute_dtype)

    def get_vmfs(self, vmf_params):
        """Activations plus the fixed random jitter of the lobe means: the same
        numbers every call, drawn from a generator seeded with random_seed."""
        bias = self.vmf_bias or {"vmf_means": 0.0, "vmf_kappas": 1.0, "vmf_logits": 1.0}
        act = self.vmf_activation or {
            "vmf_means": lambda x: x,
            "vmf_kappas": lambda x: torch.clamp(softplus(x), max=50.0),
            "vmf_logits": lambda x: torch.clamp(x, min=-50.0),
        }
        means_random = torchutil.normal(
            torch.Generator().manual_seed(self.random_seed), vmf_params.shape[:-1] + (3,),
            vmf_params.device) * self.vmf_scale / 2.0
        return {
            "vmf_means": act["vmf_means"](
                vmf_params[..., 0:3] * self.vmf_scale + bias["vmf_means"] + means_random),
            "vmf_kappas": act["vmf_kappas"](vmf_params[..., 3:4] + bias["vmf_kappas"]),
            "vmf_logits": act["vmf_logits"](vmf_params[..., 4:5] + bias["vmf_logits"]),
        }

    def forward(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                is_secondary=None, **kwargs):
        del train_frac, is_secondary, kwargs
        means = sampler_results["means"]
        pa_kwargs = self.get_predict_appearance_kwargs(rng, rays, sampler_results)
        feature = self.predict_appearance_feature(sampler_results, train=train, **pa_kwargs)
        vmf_params = self.output_layer(feature).float().reshape(
            means.shape[:-1] + (self.num_components, 5))
        vmfs = self.get_vmfs(vmf_params)
        # Means are stored relative to the query point.
        origins = means[..., None, :].detach()
        vmfs["vmf_means"] = vmfs["vmf_means"] - origins
        vmfs["vmf_origins"] = origins
        vmfs["vmf_normals"] = sampler_results[self.normals_target][..., None, :].detach()
        vmfs["weights"] = sampler_results["weights"][..., None, None].detach()
        return vmfs
