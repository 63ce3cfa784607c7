"""Physically-based material shader (counterpart of ``BaseMaterialMLP`` and
``MaterialMLP`` in ``models/material_shader.py``).

Predicts microfacet BRDF parameters from the shader's own hash grid, then
estimates outgoing radiance by importance-sampling secondary rays for the
specular and diffuse lobes with MIS, tracing them through the full radiance
cache, and Monte-Carlo integrating the clipped products.

Ported: the steady, passive path the flagship material stage runs: the
indirect lobes fused into one cache query, the microfacet material head with
per-property bias/activation/stop-gradient, the radius mask. The active
light, environment maps, surface-light-field queries and variates, BRDF
correction, emission, residual albedo, irradiance cache and the per-lobe
(unfused) path are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from neural_radiance_caching_tpu_torch.models import shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, softplus
from neural_radiance_caching_tpu_torch.ops import render_utils
from neural_radiance_caching_tpu_torch.utils import torchutil
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight

_DEFAULT_BRDF_BIAS = {
    "albedo": -1.0, "specular_albedo": -1.0, "roughness": 3.0, "F_0": 1.0, "metalness": 0.0,
    "diffuseness": 0.0, "mirrorness": 0.0, "specular_multiplier": 0.0, "diffuse_multiplier": 0.0,
}
_DEFAULT_BRDF_ACTIVATION = {
    "albedo": torch.sigmoid, "specular_albedo": torch.sigmoid, "roughness": softplus,
    "F_0": torch.sigmoid, "metalness": torch.sigmoid, "diffuseness": torch.sigmoid,
    "mirrorness": torch.sigmoid,
}
_DEFAULT_BRDF_STOPGRAD = {
    "albedo": 1.0, "specular_albedo": 1.0, "roughness": 1.0, "F_0": 1.0, "metalness": 1.0,
    "diffuseness": 1.0, "mirrorness": 1.0,
}


def _steady_integration_strategy():
    """Output key -> (lobe sub-keys summed, scale), for the passive path."""
    return {
        "indirect_occ": (("indirect_specular_indirect_occ",), 0.5),
        "radiance_out": (("direct_diffuse_radiance_out", "direct_specular_radiance_out",
                          "indirect_diffuse_radiance_out", "indirect_specular_radiance_out"), 1.0),
        "direct_radiance_out": (("direct_diffuse_radiance_out",
                                 "direct_specular_radiance_out"), 1.0),
        "indirect_radiance_out": (("indirect_diffuse_radiance_out",
                                   "indirect_specular_radiance_out"), 1.0),
        "diffuse_radiance_out": (("direct_diffuse_radiance_out",
                                  "indirect_diffuse_radiance_out"), 1.0),
        "specular_radiance_out": (("direct_specular_radiance_out",
                                   "indirect_specular_radiance_out"), 1.0),
        "direct_diffuse_radiance_out": (("direct_diffuse_radiance_out",), 1.0),
        "direct_specular_radiance_out": (("direct_specular_radiance_out",), 1.0),
        "indirect_diffuse_radiance_out": (("indirect_diffuse_radiance_out",), 1.0),
        "indirect_specular_radiance_out": (("indirect_specular_radiance_out",), 1.0),
        "irradiance": (("direct_diffuse_irradiance", "indirect_diffuse_irradiance"), 0.5),
        "direct_irradiance": (("direct_diffuse_irradiance",), 1.0),
        "indirect_irradiance": (("indirect_diffuse_irradiance",), 1.0),
    }


def _fuse_lobe_rays(spec_rays, diff_rays, ns):
    """Concatenate the two lobes' secondary rays along the secondary axis;
    fields the fan-out did not broadcast pass through from the first."""
    def cat(x, y):
        if (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dim() == y.dim()
                and x.dim() >= 2 and x.shape[0] == y.shape[0] and x.shape[1] == ns[0]
                and y.shape[1] == ns[1] and x.shape[2:] == y.shape[2:]):
            return torch.cat([x, y], dim=1)
        return x

    fields = {f: cat(getattr(spec_rays, f), getattr(diff_rays, f))
              for f in spec_rays.__dataclass_fields__}
    return type(spec_rays)(**fields)


class MaterialMLP(shading.BaseShader):
    """Steady material shader: BRDF head + secondary rays through the cache."""

    num_secondary_samples_diff = 4
    num_secondary_samples = 32
    render_num_secondary_samples_diff = 4
    render_num_secondary_samples = 32
    random_generator_2d = render_utils.RandomGenerator2D(1, 1, False)
    separate_integration_diffuse_specular = True
    diffuse_sample_fraction = 0.5
    diffuse_importance_sampler_configs = (("cosine", 1),)
    diffuse_render_importance_sampler_configs = (("cosine", 1),)
    importance_sampler_configs = (("microfacet", 1), ("cosine", 1))
    render_importance_sampler_configs = (("microfacet", 1), ("cosine", 1))
    use_indirect = True
    use_active = False
    use_env_map = False
    use_constant_fresnel = True
    use_constant_metalness = False
    use_diffuseness = False
    use_mirrorness = False
    use_specular_albedo = False
    min_roughness = 0.04
    default_F_0 = 0.04
    max_F_0 = 1.0
    brdf_bias = None
    brdf_activation = None
    brdf_stopgrad = None
    use_brdf_correction = True
    use_diffuse_emission = False
    use_residual_albedo = False
    use_irradiance_cache = False
    # Read by the BRDF correction and SLF variate paths only; accepted so the
    # flagship parameters bind unchanged.
    net_width_brdf = 64
    net_depth_brdf = 2
    near_rate = 0.1
    near_start_frac = 0.1
    near_max = 5e-1
    near_min = 1e-1
    use_surface_light_field = False
    cache_train_sampling_strategy = None
    cache_render_sampling_strategy = None
    optimize_light = True
    light_power_bias = 200.0
    rgb_max = float("inf")

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._require(use_active=False, use_env_map=False, use_surface_light_field=False,
                      use_brdf_correction=False, use_diffuse_emission=False,
                      use_residual_albedo=False, use_irradiance_cache=False,
                      separate_integration_diffuse_specular=True, use_indirect=True)
        if config.multi_illumination or config.learnable_light or config.use_transient:
            raise NotImplementedError(
                "multi-illumination, learnable lights and transient materials are not ported yet")
        if config.compute_relight_metrics or config.use_ground_truth_illumination:
            raise NotImplementedError("ground-truth illumination samplers are not ported yet")
        feature_dim = self._build_trunk(density_feature_dim)
        if self.bottleneck_width > 0:
            self.bottleneck_layer = Dense(feature_dim, self.bottleneck_width, self.compute_dtype)
            feature_dim = self.bottleneck_width
        self.pred_brdf_layer = Dense(feature_dim, 10, self.compute_dtype)
        if self.optimize_light:
            self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))

        def make(confs):
            return [(render_utils.IMPORTANCE_SAMPLER_BY_NAME[name](), count)
                    for name, count in confs]

        self._samplers = {
            ("specular", True): make(self.importance_sampler_configs),
            ("specular", False): make(self.render_importance_sampler_configs),
            ("diffuse", True): make(self.diffuse_importance_sampler_configs),
            ("diffuse", False): make(self.diffuse_render_importance_sampler_configs),
        }
        self._integration_strategy = _steady_integration_strategy()

    # --- material decode -------------------------------------------------------

    def get_material(self, brdf_params):
        bias = dict(_DEFAULT_BRDF_BIAS, **(self.brdf_bias or {}))
        act = dict(_DEFAULT_BRDF_ACTIVATION, **(self.brdf_activation or {}))
        sg = dict(_DEFAULT_BRDF_STOPGRAD, **(self.brdf_stopgrad or {}))
        # (channels of the 10-wide head, constant?, constant value, post-process)
        specs = {
            "albedo": (slice(0, self.num_rgb_channels), False, None, None),
            "specular_albedo": (slice(5, 6), False, None, None),
            "roughness": (slice(6, 7), False, None, self._post_process_roughness),
            "F_0": (slice(9, 10), self.use_constant_fresnel, self.default_F_0, None),
            "metalness": (slice(8, 9), self.use_constant_metalness, 0.0, None),
            "diffuseness": (slice(3, 4), not self.use_diffuseness, 0.0, None),
            "mirrorness": (slice(4, 5), not self.use_mirrorness, 0.0, None),
        }
        material = {}
        for prop, (sl, constant, const_val, post) in specs.items():
            raw = brdf_params[..., sl]
            if constant:
                material[prop] = torch.full_like(raw, const_val)
                continue
            value = stopgrad_with_weight(act[prop](raw + bias[prop]), sg[prop])
            if prop == "F_0":
                value = value * self.max_F_0
            if post is not None:
                value = post(value)
            material[prop] = value
        return material

    def _post_process_roughness(self, roughness):
        return roughness * (1.0 - self.min_roughness**2) + self.min_roughness**2

    def _predict_material_and_feature(self, rng, rays, sampler_results, train):
        pa_kwargs = self.get_predict_appearance_kwargs(rng, rays, sampler_results)
        feature = self.predict_appearance_feature(sampler_results, train=train, **pa_kwargs)
        if self.bottleneck_width > 0:
            feature = self.bottleneck_layer(feature)
        return feature, self.get_material(self.pred_brdf_layer(feature))

    # --- secondary rays ----------------------------------------------------------

    def _compute_near(self, train_frac):
        f32 = np.float32
        if self.near_rate > 0:
            w = np.clip((f32(train_frac) - f32(self.near_start_frac)) / f32(self.near_rate),
                        f32(0), f32(1))
            return float(w * f32(self.near_min) + (f32(1) - w) * f32(self.near_max))
        return self.near_min

    def _make_radiance_cache_fn(self, radiance_cache, train_frac, train):
        """Closure that traces secondary rays [N, S] through the full cache
        model, flattened to one ray axis for the cache forward."""

        def radiance_cache_fn(rng, ref_rays):
            lead = tuple(ref_rays.origins.shape[:-1])
            n_flat = int(np.prod(lead))
            flat = {}
            for f in ref_rays.__dataclass_fields__:
                x = getattr(ref_rays, f)
                if isinstance(x, torch.Tensor) and tuple(x.shape[:len(lead)]) == lead:
                    x = x.reshape((n_flat,) + tuple(x.shape[len(lead):]))
                flat[f] = x
            out = radiance_cache.cache(
                rng, type(ref_rays)(**flat), train_frac=train_frac, train=train,
                compute_extras=False, stopgrad_proposal=False, stopgrad_weights=False,
                is_secondary=True, linear_rgb=True, resample=True,
                sampling_strategy=(self.cache_train_sampling_strategy if train
                                   else self.cache_render_sampling_strategy))
            render = out["render"]
            rgb = torch.clamp(torch.nan_to_num(render["rgb"]), min=0.0).reshape(lead + (-1,))
            rgb_ns = torch.clamp(torch.nan_to_num(render["rgb_no_stopgrad"]), min=0.0).reshape(
                lead + (-1,))
            # Of the cache's per-level sampler results, the shading reads the
            # accumulated opacity only.
            acc = {"acc": torch.nan_to_num(render["acc"]).reshape(lead),
                   "acc_no_stopgrad": torch.nan_to_num(render["acc_no_stopgrad"]).reshape(lead)}
            return rgb, rgb_ns, [acc]

        return radiance_cache_fn

    def _sample_lobe_rays(self, rng, rays, sampler_results, material_sec, light_sec, samplers,
                          num_secondary_samples, train_frac):
        """Fan one lobe out into secondary rays + importance-sample records."""
        ref_rays, ref_samples = render_utils.get_secondary_rays(
            rng, rays, sampler_results["points"], rays.viewdirs,
            sampler_results[self.normals_target], material_sec,
            refdir_eps=self._compute_near(train_frac), normal_eps=self.config.secondary_normal_eps,
            random_generator_2d=self.random_generator_2d, samplers=samplers,
            num_secondary_samples=num_secondary_samples, light_sampler_results=light_sec,
            far=self.config.secondary_far)
        if self.config.material_loss_radius < float("inf"):
            # No shading gradient through secondary rays that start outside
            # the scene radius.
            mask = (torch.linalg.norm(ref_rays.origins, dim=-1, keepdim=True)
                    < self.config.material_loss_radius).to(torch.float32)
            for d in ("local_viewdirs", "local_lightdirs", "global_viewdirs", "global_lightdirs"):
                ref_samples[d] = stopgrad_with_weight(ref_samples[d], mask)
        ref_samples["weight"] = torch.where(ref_samples["local_lightdirs"][..., 2:] > 0.0,
                                            ref_samples["weight"], 0.0)
        return ref_rays, ref_samples

    def _attach_lobe_radiance(self, rgb, rgb_ns, ref_samples, ref_sampler_results,
                              num_secondary_samples):
        """Reshape the queried radiance and attach it, the per-ray opacity and
        the (unit) BRDF correction to the lobe's sample records."""
        rgb = torch.nan_to_num(rgb)
        rgb_ns = torch.nan_to_num(rgb_ns)
        shape = (-1, num_secondary_samples, self.num_rgb_channels)
        rgb, rgb_ns = rgb.reshape(shape), rgb_ns.reshape(shape)
        ref_samples = {k: v.reshape(rgb.shape[0], -1, v.shape[-1]) for k, v in ref_samples.items()}
        occ_acc = ref_sampler_results[-1]["acc"].reshape(rgb.shape[0], rgb.shape[1], -1)[..., :1]
        ref_samples.update(
            radiance_in=rgb, indirect_occ=occ_acc, radiance_in_no_stopgrad=rgb_ns,
            brdf_correction=torch.ones_like(ref_samples["local_lightdirs"][..., :2]))
        return ref_samples

    def _process_indirect_lobes_fused(self, rng, rays, sampler_results, material,
                                      num_secondary_samples, radiance_cache_fn, train_frac, train,
                                      light_sampler_results, integrated_outputs):
        """Both indirect lobes through one radiance query: each keeps its own
        samplers and MIS pdfs, their secondary rays are concatenated along the
        secondary axis and traced in a single cache forward, and the results
        split back per lobe and integrate as two separate queries would."""
        frac = self.diffuse_sample_fraction
        lobes = []
        for comp in ("specular", "diffuse"):
            n = int(np.round(num_secondary_samples * (frac if comp == "diffuse" else 1.0 - frac)))
            lobes.append((comp, n, self._samplers[(comp, bool(train))], f"microfacet_{comp}"))
        ns = [n for _, n, _, _ in lobes]
        if min(ns) == 0:
            raise NotImplementedError("a lobe with no secondary samples (the per-lobe path) "
                                      "is not ported yet")
        sh = sampler_results["points"].shape
        # Ray directions take no gradient into the material or the light sampler.
        material_sec = {k: v.detach() for k, v in material.items()}
        light_sec = (None if light_sampler_results is None
                     else {k: v.detach() for k, v in light_sampler_results.items()})

        key, rng = torchutil.random_split(rng)
        sampled = [self._sample_lobe_rays(key, rays, sampler_results, material_sec, light_sec,
                                          samplers, n, train_frac)
                   for _, n, samplers, _ in lobes]
        n_total = sum(ns)
        fused_rays = _fuse_lobe_rays(sampled[0][0], sampled[1][0], ns)
        key, rng = torchutil.random_split(rng)
        rgb, rgb_ns, srs = radiance_cache_fn(key, fused_rays)
        rgb = rgb.reshape(-1, n_total, self.num_rgb_channels)
        rgb_ns = rgb_ns.reshape(-1, n_total, self.num_rgb_channels)

        offset = 0
        for (comp, n, _, material_type), (rr, rs) in zip(lobes, sampled):
            lo, hi = offset, offset + n
            offset = hi
            srs_l = [{k: v[:, lo:hi] for k, v in srs[-1].items()}]
            ref_samples = self._attach_lobe_radiance(rgb[:, lo:hi], rgb_ns[:, lo:hi], rs, srs_l, n)
            integrated = render_utils.integrate_reflect_rays(
                material_type, self.use_brdf_correction, material, ref_samples,
                use_diffuseness=self.use_diffuseness, use_mirrorness=self.use_mirrorness,
                use_specular_albedo=self.use_specular_albedo, max_radiance=self.rgb_max)
            integrated_outputs[f"ref_rays_indirect_{comp}"] = rr
            integrated_outputs[f"ref_samples_indirect_{comp}"] = ref_samples
            integrated_outputs[f"ref_sampler_results_indirect_{comp}"] = srs_l
            for k, val in integrated.items():
                # Degenerate MC draws (grazing GGX half-vectors) can yield
                # isolated non-finite samples; they are zeroed, not propagated.
                val = val.reshape(tuple(sh[:-1]) + (val.shape[-1],))
                integrated_outputs[f"indirect_{comp}_{k}"] = torch.nan_to_num(val)

    def get_outgoing_radiance(self, rng, rays, sampler_results, material, num_secondary_samples,
                              radiance_cache_fn, train_frac=1.0, train=True,
                              light_sampler_results=None):
        """All lobes of the outgoing-radiance estimate, combined per the
        integration strategy."""
        out = {k: 0.0 for k in self._integration_strategy}
        self._process_indirect_lobes_fused(
            rng, rays, sampler_results, material, num_secondary_samples, radiance_cache_fn,
            train_frac, train, light_sampler_results, out)
        for output_key, (sub_keys, scale) in self._integration_strategy.items():
            total = 0.0
            for sub_key in sub_keys:
                total = total + out.get(sub_key, 0.0)
            out[output_key] = total * scale
        return out

    # --- top level ---------------------------------------------------------------

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           radiance_cache=None, light_sampler_results=None, material_only=False,
                           slf_variate=False, **kwargs):
        del kwargs
        if slf_variate:
            raise NotImplementedError("the surface-light-field variate is not ported yet")
        key, rng = torchutil.random_split(rng)
        feature, material = self._predict_material_and_feature(key, rays, sampler_results, train)
        if material_only:
            return {"material_" + k: v for k, v in material.items()}
        emission = torch.zeros_like(material["albedo"])
        outputs = {"material_residual_albedo": torch.zeros_like(material["albedo"])}
        key, rng = torchutil.random_split(rng)
        integrated = self.get_outgoing_radiance(
            key, rays, sampler_results, material,
            self.num_secondary_samples if train else self.render_num_secondary_samples,
            self._make_radiance_cache_fn(radiance_cache, train_frac, train),
            train_frac=train_frac, train=train, light_sampler_results=light_sampler_results)
        self._finalize_outputs(rays, outputs, integrated, integrated["radiance_out"], material,
                               emission, sampler_results)
        return outputs

    def _finalize_outputs(self, rays, outputs, integrated, final_rgb, material, emission,
                          sampler_results):
        for k in material:
            outputs["material_" + k] = material[k]
        outputs["lighting_emission"] = emission
        outputs["lighting_irradiance"] = integrated["irradiance"].reshape(material["albedo"].shape)
        if "occ" not in sampler_results:
            outputs["occ"] = torch.zeros_like(final_rgb)
        outputs["rgb"] = final_rgb
        outputs["direct_diffuse_rgb"] = integrated["direct_diffuse_radiance_out"] + emission
        outputs["direct_specular_rgb"] = integrated["direct_specular_radiance_out"]
        outputs["direct_rgb"] = integrated["direct_radiance_out"]
        outputs["indirect_diffuse_rgb"] = integrated["indirect_diffuse_radiance_out"]
        outputs["indirect_specular_rgb"] = integrated["indirect_specular_radiance_out"]
        outputs["indirect_rgb"] = integrated["indirect_radiance_out"]
        outputs["indirect_occ"] = integrated["indirect_occ"]
        outputs["diffuse_rgb"] = integrated["diffuse_radiance_out"]
        outputs["specular_rgb"] = integrated["specular_radiance_out"]
        for f in integrated:
            if f.startswith("ref_"):
                outputs[f] = integrated[f]
        outputs["ray_dists"] = torch.linalg.norm(
            rays.origins[..., None, :] - sampler_results["means"], dim=-1, keepdim=True)
        # Radius mask: no gradient from surface points outside the scene radius.
        mask = (torch.linalg.norm(sampler_results["means"], dim=-1, keepdim=True)
                < self.config.material_loss_radius).to(torch.float32)
        for k, v in outputs.items():
            if isinstance(v, torch.Tensor) and v.dim() == mask.dim():
                outputs[k] = stopgrad_with_weight(v, mask)

