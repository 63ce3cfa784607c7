"""Physically-based material shaders (counterpart of ``BaseMaterialMLP``,
``MaterialMLP`` and ``TransientMaterialMLP`` in ``models/material_shader.py``).

Predicts microfacet BRDF parameters from the shader's own hash grid, then
estimates outgoing radiance by importance-sampling secondary rays for the
specular and diffuse lobes with MIS, tracing them through the full radiance
cache, and Monte-Carlo integrating the clipped products.

``MaterialMLP`` is the steady, passive path the flagship material stage runs:
the indirect lobes fused into one cache query, the microfacet material head
with per-property bias/activation/stop-gradient, the radius mask.

``TransientMaterialMLP`` (InvProp) adds the active light: one direct lobe
toward the light (one sample traced with the active sampler, shared by the
specular and diffuse lobes), lit by the material model's learnable light
source (``LightSourceMap``, with ``Config.learnable_light``) or by a point
light of the shader's own power, and occluded by the cache's stored
occlusion. The indirect lobes' radiance from the transient cache is
time-binned, [P, S, bins, C], and so are the indirect outputs; the direct
ones are not, and ``rgb`` is the direct radiance.

Gradient through the secondary rays is scaled as in JAX: their shading
directions by ``stopgrad_shading_weight`` (times the scene-radius mask),
their cache queries by ``stopgrad_cache_weight`` (the rays' fields, then
the radiance that comes back). The cache's per-level results on those rays
are kept for ``material_ray_sampler``; their proposal levels run without
a graph when the caller asks (``secondary_proposal_grad``). Under the
material model's ``share_light_power`` the cache queries are lit by this
shader's light power; with ``shadow_eps_indirect`` the secondary rays carry
their surface point's normal (``Config.shadow_normals_target``), off which
the cache's sampler pushes their near bound.

With ``use_surface_light_field`` the secondary rays query the cache's
surface light field memory instead of rendering the cache
(``_make_surface_lf_fn``); under the material model's ``slf_variate`` the
shader estimates instead the difference of the cache and the memory along
one set of secondary rays (``_integrate_slf_variate``, at
``num_secondary_samples_diff``): the cache's lobes are traced first, fused,
and the memory's reuse their rays and sample records, lobe by lobe. Every
output of the two estimates is kept under ``<key>_cache`` and ``<key>_slf``,
and the cache's irradiance is the ``irradiance_cache`` output.

The learned BRDF correction (``use_brdf_correction``, JAX's default: a
2-channel specular / diffuse multiplier from the sorted view and light
cosines and their dot product, positionally encoded, with the half and
difference vectors under ``anisotropic_brdf_correction``, and the point's
feature unless ``global_brdf_correction``; or the feature alone under
``per_point_brdf_correction``), the diffuse emission head (with its
window and variate weights) and the residual albedo, ``reparam_roughness``,
``use_constant_material``, MIS off and the stratified generator, the
light sampler's gradient (``stopgrad_light=False``), the cache's own
secondary sampling without resampling (``resample_cache=False``), and the
per-lobe path of fresh rays (one lobe at a time, which
``separate_integration_diffuse_specular=False`` and a lobe without samples
take: a lobe without samples then leaves its outputs the float 0.0, as in
JAX) follow the JAX shader. The transient shader runs without its indirect
lobes (``use_indirect=False``). Where JAX itself fails (the phong and
lambertian decodes, the steady shader without indirect lobes or without a
diffuse sample, the transient shader's per-lobe path) the port raises
naming JAX's failure. With ``use_env_map`` (the steady shader) the
indirect lobes run one at a time, each querying its radiance source, and
the direct lobes are lit by the cache's environment map along the
indirect lobes' rays, where the cache (or the SLF memory) left them
transparent (``_make_env_map_fn``, its gradient scaled by
``stopgrad_env_map_weight``); the cache and memory queries then pass
``use_env_map=False``. The transient shader's point light can be a cone
(``light_max_angle``). The irradiance-cache fields are read by nothing, as
in JAX (the irradiance cache's output is the SLF variate's), and so is the
illumination embedding under ``Config.multi_illumination`` (JAX never
calls it). A relit render
(``Config.compute_relight_metrics``) and the ground-truth illumination
under ``Config.multi_illumination`` raise as reference gaps: the JAX
trainer hands its shader's environment sampler no env map tables. So does
structured light (``shading.SL_RELIGHT_GAP``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import light_sampler as light_sampler_lib
from neural_radiance_caching_tpu_torch.models import nerf_shader, shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math, render_utils
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


def _steady_integration_strategy(use_active):
    """Output key -> ((lobe sub-key, dims it is summed over), ...), scale."""
    def s(*keys):
        return tuple((k, ()) for k in keys)

    extra = {"occ": (s("direct_diffuse_occ"), 1.0)} if use_active else {}
    return dict(
        **extra,
        indirect_occ=(s("indirect_specular_indirect_occ"), 0.5),
        radiance_out=(s("direct_diffuse_radiance_out", "direct_specular_radiance_out",
                        "indirect_diffuse_radiance_out", "indirect_specular_radiance_out"), 1.0),
        direct_radiance_out=(s("direct_diffuse_radiance_out", "direct_specular_radiance_out"), 1.0),
        indirect_radiance_out=(s("indirect_diffuse_radiance_out",
                                 "indirect_specular_radiance_out"), 1.0),
        diffuse_radiance_out=(s("direct_diffuse_radiance_out", "indirect_diffuse_radiance_out"),
                              1.0),
        specular_radiance_out=(s("direct_specular_radiance_out",
                                 "indirect_specular_radiance_out"), 1.0),
        direct_diffuse_radiance_out=(s("direct_diffuse_radiance_out"), 1.0),
        direct_specular_radiance_out=(s("direct_specular_radiance_out"), 1.0),
        indirect_diffuse_radiance_out=(s("indirect_diffuse_radiance_out"), 1.0),
        indirect_specular_radiance_out=(s("indirect_specular_radiance_out"), 1.0),
        irradiance=(s("direct_diffuse_irradiance", "indirect_diffuse_irradiance"), 0.5),
        direct_irradiance=(s("direct_diffuse_irradiance"), 1.0),
        indirect_irradiance=(s("indirect_diffuse_irradiance"), 1.0),
    )


def _transient_integration_strategy():
    """The active steady table, with the bins axis of the indirect lobes
    summed where a total meets a direct (unbinned) term."""
    strategy = _steady_integration_strategy(use_active=True)
    bins = (-2,)
    strategy.update(
        radiance_out=((("direct_diffuse_radiance_out", ()), ("direct_specular_radiance_out", ()),
                       ("indirect_diffuse_radiance_out", bins),
                       ("indirect_specular_radiance_out", bins)), 1.0),
        diffuse_radiance_out=((("direct_diffuse_radiance_out", ()),
                               ("indirect_diffuse_radiance_out", bins)), 1.0),
        specular_radiance_out=((("direct_specular_radiance_out", ()),
                                ("indirect_specular_radiance_out", bins)), 1.0),
        irradiance=((("direct_diffuse_irradiance", ()), ("indirect_diffuse_irradiance", bins)),
                    0.5),
        indirect_irradiance=((("indirect_diffuse_irradiance", bins),), 1.0),
    )
    return strategy


# The fields of the cache's per-level results on secondary rays that a loss
# reads: the interlevel, distortion, orientation and predicted-normal terms
# of material_ray_sampler.
_SECONDARY_RESULT_KEYS = ("sdist", "tdist", "weights", "lossmult", "normals", "normals_pred",
                          "normals_to_use")


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


# The JAX decode's failure under a material type other than microfacet: the
# shader integrates its lobes as microfacet_* whatever the type.
_MATERIAL_TYPE_GAP = (
    "MaterialMLP.material_type={!r} is a reference gap: the JAX shader decodes {} but "
    "integrates every lobe as microfacet_specular / microfacet_diffuse, whose get_lobe reads "
    "materials['roughness'] and raises KeyError: 'roughness' (ops/render_utils.py:660, from "
    "material_shader.py:885) at the first step")
# The steady shader without a diffuse lobe: its irradiance stays the float 0.0.
_NO_IRRADIANCE_GAP = (
    "{} is a reference gap: the steady JAX shader then integrates no diffuse lobe, so "
    "integrated['irradiance'] stays the float 0.0 that material_shader.py:1065 seeds and "
    "material_shader.py:1295 raises AttributeError: 'float' object has no attribute "
    "'reshape' at the first step")


class BaseMaterialMLP(shading.BaseShader, unported=dict(
        env_importance_samplers=(("EnvironmentSampler", 1.0),),
        active_importance_samplers=(("ActiveSampler", 1.0),))):
    """BRDF head + secondary rays through the cache; the variants set the
    lighting (passive or active) and the integration table."""

    num_secondary_samples_diff = 4
    num_secondary_samples = 32
    render_num_secondary_samples_diff = 4
    render_num_secondary_samples = 32
    random_generator_2d = render_utils.RandomGenerator2D(1, 1, False)
    # Passed through to the fan-out, which ignores it as JAX's does: the
    # generator's own `stratified` decides.
    stratified_sampling = False
    use_mis = True
    separate_integration_diffuse_specular = True
    diffuse_sample_fraction = 0.5
    diffuse_importance_sampler_configs = (("cosine", 1),)
    diffuse_render_importance_sampler_configs = (("cosine", 1),)
    importance_sampler_configs = (("microfacet", 1), ("cosine", 1))
    render_importance_sampler_configs = (("microfacet", 1), ("cosine", 1))
    use_indirect = True
    use_active = False
    # The direct lobes lit by the cache's environment map (steady shader).
    use_env_map = False
    material_type = "microfacet"
    # The material heads' input: points and means zeroed (one material for
    # the whole scene), metalness 1 and roughness 0.01.
    use_constant_material = False
    use_constant_fresnel = True
    use_constant_metalness = False
    use_diffuseness = False
    use_mirrorness = False
    use_specular_albedo = False
    # The roughness head's value r becomes 1 / (r + 1) before the floor.
    reparam_roughness = False
    min_roughness = 0.04
    default_F_0 = 0.04
    max_F_0 = 1.0
    brdf_bias = None
    brdf_activation = None
    brdf_stopgrad = None
    use_brdf_correction = True
    anisotropic_brdf_correction = False
    per_point_brdf_correction = False
    global_brdf_correction = False
    deg_brdf = 2
    deg_brdf_anisotropic = 2
    use_diffuse_emission = False
    use_residual_albedo = False
    # The emission's gradient scale eases from _start to _end over the first
    # emission_window_frac of training (at once without a window).
    emission_window_frac = 0.0
    emission_variate_weight_start = 1.0
    emission_variate_weight_end = 1.0
    # Declared by the JAX material shaders and read by nothing there (the
    # irradiance cache's output is the SLF variate's, not these fields').
    use_irradiance_cache = False
    irradiance_cache_weight = 1.0
    irradiance_cache_stopgrad_weight = 1.0
    irradiance_cache_decay_rate = 1.0
    stopgrad_variate_weight = 1.0
    use_mesh_points = True
    use_mesh_points_for_prediction = True
    use_mesh_normals = True
    use_corrected_normals = False
    multiple_illumination_outputs = True
    stopgrad_occ_weight = 0.0
    # The (rays, outputs) gradient scales of the environment map's queries.
    stopgrad_env_map_weight = (1.0, 1.0)
    # The secondary rays carry their surface point's normal
    # (Config.shadow_normals_target), and the sampler pushes their near
    # bound off the surface along it.
    shadow_eps_indirect = False
    # Read by the emission, residual-albedo and irradiance-cache heads only.
    rgb_emission_activation = staticmethod(torch.sigmoid)
    rgb_bias_emission = -1.0
    rgb_residual_albedo_activation = staticmethod(torch.sigmoid)
    rgb_bias_residual_albedo = -1.0
    rgb_irradiance_activation = staticmethod(math.safe_exp)
    rgb_bias_irradiance = 0.0
    # Secondary rays' directions take the material's (and the light
    # sampler's) gradient unless set.
    stopgrad_material = True
    stopgrad_light = True
    # The cache resamples its samples along the secondary rays.
    resample_cache = True
    # JAX defines the material shader's illumination embedding and never
    # calls it, so it has no parameter: these fields are read by nothing.
    num_light_features = 64
    use_illumination_feature = False
    # The BRDF correction MLP.
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
    light_power_activation = staticmethod(math.abs_)
    light_max_angle = 0.0
    stopgrad_direct_weight = 1.0
    stopgrad_indirect_weight = 1.0
    # The gradient scale of the secondary rays' shading directions, and the
    # (rays, outputs) gradient scales of their cache queries.
    stopgrad_shading_weight = 1.0
    # Detach the secondary rays' sample records, their rays, or the radiance
    # their cache queries return.
    stopgrad_samples = False
    stopgrad_rays = False
    stopgrad_rgb = False
    stopgrad_cache_weight = (1.0, 1.0)
    # The (rays, outputs) gradient scales of the surface-light-field queries;
    # the memory applies the outputs' alone (NeRFModel.get_slf_results).
    stopgrad_slf_weight = (1.0, 1.0)
    rgb_max = float("inf")

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._check_variant(config)
        if self.material_type not in ("microfacet", "phong", "lambertian"):
            raise ValueError(f"Unsupported material type: {self.material_type}")
        if self.material_type != "microfacet":
            raise NotImplementedError(_MATERIAL_TYPE_GAP.format(
                self.material_type, {"phong": "albedo, specular_albedo and specular_exponent",
                                     "lambertian": "albedo alone"}[self.material_type]))
        if config.multi_illumination and config.use_ground_truth_illumination:
            raise NotImplementedError(
                "Config.use_ground_truth_illumination under Config.multi_illumination is a "
                "reference gap: the JAX trainer hands the model none of the dataset's env_map "
                "tables, so the material shader's EnvironmentSampler "
                "(material_shader.py:252-270) reads env_map_pmf = None and raises ValueError "
                "('No input was provided to the clip function', ops/render_utils.py:417-432)")
        if config.compute_relight_metrics:
            raise NotImplementedError(
                "a relit material render (Config.compute_relight_metrics) is a reference gap: "
                "the JAX trainer hands the model none of the dataset's env_map tables, so its "
                "EnvironmentSampler reads env_map_pmf = None and raises ValueError ('No input "
                "was provided to the clip function', ops/render_utils.py:417-432)")
        feature_dim = self._build_trunk(density_feature_dim)
        if self.bottleneck_width > 0:
            self.bottleneck_layer = Dense(feature_dim, self.bottleneck_width, self.compute_dtype)
            feature_dim = self.bottleneck_width
        self.pred_brdf_layer = Dense(feature_dim, 10, self.compute_dtype)
        # JAX creates each head at its first call, and only under its option.
        if self.use_diffuse_emission:
            self.rgb_diffuse_emission_layer = Dense(feature_dim, self.num_rgb_channels,
                                                    self.compute_dtype)
        if self.use_residual_albedo:
            self.rgb_residual_albedo_layer = Dense(feature_dim, self.num_rgb_channels,
                                                   self.compute_dtype)
        if self.use_brdf_correction:
            self._build_brdf_correction(feature_dim)
        if self.optimize_light:
            self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))
        if config.learnable_light:
            self.learnable_light = light_sampler_lib.LightSourceMap(config=config)

        def make(confs):
            return [(render_utils.IMPORTANCE_SAMPLER_BY_NAME[name](), count)
                    for name, count in confs]

        self._samplers = {
            ("specular", True): make(self.importance_sampler_configs),
            ("specular", False): make(self.render_importance_sampler_configs),
            ("diffuse", True): make(self.diffuse_importance_sampler_configs),
            ("diffuse", False): make(self.diffuse_render_importance_sampler_configs),
        }
        self._active_samplers = make((("active", 1),))
        self._integration_strategy = self._build_integration_strategy()

    def _check_variant(self, config):
        raise NotImplementedError

    def _build_integration_strategy(self):
        raise NotImplementedError

    def _lobe_sizes(self, num_secondary_samples):
        """{lobe: its secondary samples}: the diffuse fraction of them, the
        rest specular; all diffuse without separate integration (whose
        diffuse lobe samples with the specular samplers)."""
        frac = (self.diffuse_sample_fraction if self.separate_integration_diffuse_specular
                else 1.0)
        return {"specular": int(np.round(num_secondary_samples * (1.0 - frac))),
                "diffuse": int(np.round(num_secondary_samples * frac))}

    def _lobe_samplers(self, comp, train):
        if comp == "diffuse" and not self.separate_integration_diffuse_specular:
            comp = "specular"
        return self._samplers[(comp, bool(train))]

    # --- BRDF correction ---------------------------------------------------------

    def _brdf_input_dim(self):
        dim = 3 + 3 * 2 * self.deg_brdf
        if self.anisotropic_brdf_correction:
            dim += 6 + 6 * 2 * self.deg_brdf_anisotropic
        return dim

    def _build_brdf_correction(self, feature_dim):
        """The correction's output layer over the point's feature
        (per_point_brdf_correction) or over its MLP, whose input is the
        encoded directions and, unless global_brdf_correction, the feature."""
        if self.per_point_brdf_correction:
            self.output_brdf_correction_layer = Dense(feature_dim, 2, self.compute_dtype)
            return
        in_dim = self._brdf_input_dim() + (0 if self.global_brdf_correction else feature_dim)
        layers = []
        for _ in range(self.net_depth_brdf):
            layers.append(Dense(in_dim, self.net_width_brdf, self.compute_dtype))
            in_dim = self.net_width_brdf
        self.brdf_correction_layers = nn.ModuleList(layers)
        self.output_brdf_correction_layer = Dense(in_dim, 2, self.compute_dtype)

    def _process_brdf_output(self, x):
        bias = dict(_DEFAULT_BRDF_BIAS, **(self.brdf_bias or {}))
        return torch.cat([torch.sigmoid(x[..., 0:1] + bias["specular_multiplier"]),
                          torch.sigmoid(x[..., 1:2] + bias["diffuse_multiplier"])], dim=-1)

    def get_brdf_correction(self, feature, ref_samples, num_secondary_samples):
        """The learned (specular, diffuse) multipliers of one lobe's samples
        [P, S, 2]."""
        if self.per_point_brdf_correction:
            out = self._process_brdf_output(self.output_brdf_correction_layer(feature))
            return out.reshape(-1, 1, out.shape[-1]).repeat_interleave(num_secondary_samples,
                                                                       dim=-2)
        lightdirs, viewdirs = ref_samples["local_lightdirs"], ref_samples["local_viewdirs"]
        cosines = torch.cat([torch.broadcast_to(viewdirs[..., 2:3], lightdirs.shape[:-1] + (1,)),
                             lightdirs[..., 2:3]], dim=-1)
        x = torch.cat([torch.sort(cosines, dim=-1).values, math.dot(viewdirs, lightdirs)], dim=-1)
        x = coord.pos_enc(x, 0, self.deg_brdf, True)
        if self.anisotropic_brdf_correction:
            gv, gl = ref_samples["global_viewdirs"], ref_samples["global_lightdirs"]
            aniso = torch.cat([gv + gl, torch.abs(gv - gl)], dim=-1)
            x = torch.cat([x, coord.pos_enc(aniso, 0, self.deg_brdf_anisotropic, True)], dim=-1)
        if not self.global_brdf_correction:
            pos = feature.reshape(-1, 1, feature.shape[-1]).repeat_interleave(
                num_secondary_samples, dim=-2)
            x = torch.cat([x, pos], dim=-1)
        for layer in self.brdf_correction_layers:
            x = self.net_activation(layer(x))
        return self._process_brdf_output(self.output_brdf_correction_layer(x))

    def _secondary_material(self, material):
        """The material that samples secondary-ray directions."""
        if not self.stopgrad_material:
            return material
        return {k: v.detach() for k, v in material.items()}

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
        if self.reparam_roughness:
            roughness = 1.0 / (roughness + 1.0)
        return roughness * (1.0 - self.min_roughness**2) + self.min_roughness**2

    def _predict_material_and_feature(self, rng, rays, sampler_results, train):
        if self.use_constant_material:
            sampler_results = dict(sampler_results, points=torch.zeros_like(
                sampler_results["points"]), means=torch.zeros_like(sampler_results["means"]))
        pa_kwargs = self.get_predict_appearance_kwargs(rng, rays, sampler_results)
        feature = self.predict_appearance_feature(sampler_results, train=train, **pa_kwargs)
        if self.bottleneck_width > 0:
            feature = self.bottleneck_layer(feature)
        material = self.get_material(self.pred_brdf_layer(feature))
        if self.use_constant_material:
            material["metalness"] = torch.ones_like(material["metalness"])
            material["roughness"] = torch.ones_like(material["roughness"]) * 0.01
        return feature, material

    # --- secondary rays ----------------------------------------------------------

    def _compute_near(self, train_frac):
        f32 = np.float32
        if self.near_rate > 0:
            w = np.clip((f32(train_frac) - f32(self.near_start_frac)) / f32(self.near_rate),
                        f32(0), f32(1))
            return float(w * f32(self.near_min) + (f32(1) - w) * f32(self.near_max))
        return self.near_min

    def _radius_mask(self, points):
        """1 where `points` lie inside the scene radius, else 0 ([..., 1])."""
        return (torch.linalg.norm(points, dim=-1, keepdim=True)
                < self.config.material_loss_radius).to(torch.float32)

    def _light_power(self):
        """The activated light power (the shader's own parameter, or its
        bias when the light is not optimised)."""
        if self.optimize_light:
            return self.light_power_activation(self.light_power)
        device = self.pred_brdf_layer.weight.device
        return self.light_power_activation(torch.tensor(float(self.light_power_bias),
                                                        device=device))

    def _with_surface_normals(self, ref_rays, sampler_results):
        """The secondary rays carrying their surface point's normal
        (``Config.shadow_normals_target``) under shadow_eps_indirect, and no
        normals otherwise."""
        normals = None
        if self.shadow_eps_indirect:
            normals = sampler_results[self.config.shadow_normals_target].reshape(
                ref_rays.origins.shape[:-2] + (-1, 3)) * torch.ones_like(ref_rays.origins)
        return ref_rays.replace(normals=normals)

    def _make_surface_lf_fn(self, radiance_cache, sampler_results, train_frac, train):
        """Closure that queries the cache's surface light field memory along
        secondary rays [N, S]: the radiance [N, S, C] (no gradient from rays
        that start outside the scene radius), and the memory's outputs as
        the one level of its "sampler results"."""

        def surface_lf_fn(rng, ref_rays):
            ref_rays = self._with_surface_normals(ref_rays, sampler_results)
            slf = radiance_cache.cache(rng, ref_rays, use_slf=True, use_env_map=False, train=train,
                                       train_frac=train_frac,
                                       stopgrad_cache_weight=self.stopgrad_slf_weight)
            rgb = slf["rgb"].reshape(ref_rays.origins.shape)
            rgb_ns = slf["rgb_no_stopgrad"].reshape(ref_rays.origins.shape)
            if self.config.material_loss_radius < float("inf"):
                mask = self._radius_mask(ref_rays.origins)
                rgb, rgb_ns = stopgrad_with_weight(rgb, mask), stopgrad_with_weight(rgb_ns, mask)
            slf["acc"] = slf["acc"].reshape(ref_rays.origins.shape[:-1])
            slf["acc_no_stopgrad"] = slf["acc_no_stopgrad"].reshape(ref_rays.origins.shape[:-1])
            return torch.clamp(rgb, min=0.0), torch.clamp(rgb_ns, min=0.0), [slf]

        return surface_lf_fn

    def _make_radiance_cache_fn(self, radiance_cache, sampler_results, train_frac, train,
                                proposal_grad=True, mesh=None):
        """Closure that traces secondary rays [N, S] through the full cache
        model, flattened to one ray axis for the cache forward; the radiance
        comes back as [N, S, C], or [N, S, bins, C] from a transient cache,
        with the cache's per-level sampler results [N, S, ...].
        With shadow_eps_indirect the rays carry their surface point's normal;
        under the model's share_light_power the cache shader is lit with this
        shader's power. proposal_grad=False runs the cache's proposal levels
        without a graph. mesh: the rays take the cache's mesh shortcut."""

        def radiance_cache_fn(rng, ref_rays):
            ref_rays = self._with_surface_normals(ref_rays, sampler_results)
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
                is_secondary=True, linear_rgb=True, resample=self.resample_cache,
                sampling_strategy=(self.cache_train_sampling_strategy if train
                                   else self.cache_render_sampling_strategy),
                radiance_cache=radiance_cache, stopgrad_cache_weight=self.stopgrad_cache_weight,
                proposal_grad=proposal_grad, mesh=mesh, use_env_map=False,
                light_power=self._light_power() if radiance_cache.share_light_power else None)
            render = out["render"]

            def unflatten(x):
                return x.reshape(lead + tuple(x.shape[1:]))

            rgb = torch.clamp(torch.nan_to_num(unflatten(render["rgb"])), min=0.0)
            rgb_ns = torch.clamp(torch.nan_to_num(unflatten(render["rgb_no_stopgrad"])), min=0.0)
            # Of the per-level sampler results, the fields the secondary-ray
            # losses read (material_ray_sampler): keeping the rest would hold
            # activations that gradient checkpointing frees.
            srs = [{k: unflatten(level[k]) if isinstance(level.get(k), torch.Tensor)
                    else level.get(k) for k in _SECONDARY_RESULT_KEYS}
                   for level in out["main"]["sampler"]]
            srs[-1]["acc"] = torch.nan_to_num(render["acc"]).reshape(lead)
            srs[-1]["acc_no_stopgrad"] = torch.nan_to_num(render["acc_no_stopgrad"]).reshape(lead)
            return rgb, rgb_ns, srs

        return radiance_cache_fn

    def _make_env_map_fn(self, radiance_cache, train_frac, train):
        """Closure that queries the cache's environment map along secondary
        rays [N, S] (``env_map_only``, its gradient scaled by
        ``stopgrad_env_map_weight``): the radiance [N, S, C] times the
        transparency that the lobe's own query, `ref_sampler_results`, left
        along each ray (its `_no_stopgrad` twin by the unscaled opacity)."""

        def env_map_fn(rng, ref_rays, ref_sampler_results):
            env = radiance_cache.cache(rng, ref_rays, env_map_only=True, use_env_map=True,
                                       train=train, train_frac=train_frac,
                                       stopgrad_cache_weight=self.stopgrad_env_map_weight)
            shape = ref_rays.origins.shape
            rgb = env["incoming_rgb"].reshape(shape)
            rgb_ns = env.get("incoming_rgb_no_stopgrad", rgb).reshape(shape)
            last = ref_sampler_results[-1]
            rgb = torch.clamp(rgb, min=0.0) * (1.0 - last["acc"].reshape(shape[:-1] + (1,)))
            rgb_ns = torch.clamp(rgb_ns, min=0.0) * (
                1.0 - last["acc_no_stopgrad"].reshape(shape[:-1] + (1,)))
            return rgb, rgb_ns, ref_sampler_results

        return env_map_fn

    def _sample_lobe_rays(self, rng, rays, sampler_results, material_sec, light_sec, samplers,
                          num_secondary_samples, train_frac, mesh=None):
        """Fan one lobe out into secondary rays + importance-sample records;
        with a mesh, the rays start at their near point."""
        ref_rays, ref_samples = render_utils.get_secondary_rays(
            rng, rays, sampler_results["points"], rays.viewdirs,
            sampler_results[self.normals_target], material_sec,
            refdir_eps=self._compute_near(train_frac), normal_eps=self.config.secondary_normal_eps,
            random_generator_2d=self.random_generator_2d,
            stratified_sampling=self.stratified_sampling, use_mis=self.use_mis,
            samplers=samplers, num_secondary_samples=num_secondary_samples,
            light_sampler_results=light_sec,
            offset_origins=mesh is not None, far=self.config.secondary_far)
        shading_w = self.stopgrad_shading_weight
        if self.config.material_loss_radius < float("inf"):
            # No shading gradient through secondary rays that start outside
            # the scene radius.
            shading_w = self._radius_mask(ref_rays.origins) * shading_w
        for d in ("local_viewdirs", "local_lightdirs", "global_viewdirs", "global_lightdirs"):
            ref_samples[d] = stopgrad_with_weight(ref_samples[d], shading_w)
        ref_samples["weight"] = torch.where(ref_samples["local_lightdirs"][..., 2:] > 0.0,
                                            ref_samples["weight"], 0.0)
        if self.stopgrad_samples:
            ref_samples = {k: v.detach() for k, v in ref_samples.items()}
        if self.stopgrad_rays:
            ref_rays = torchutil.partial_stopgrad_rays(ref_rays, (0.0, 0.0))
        return ref_rays, ref_samples

    def _radiance_shape(self, num_secondary_samples, direct):
        if direct or not self.config.use_transient:
            return (-1, num_secondary_samples, self.num_rgb_channels)
        return (-1, num_secondary_samples, self.config.n_bins, self.num_rgb_channels)

    def _attach_lobe_radiance(self, rgb, rgb_ns, ref_samples, ref_sampler_results, feature,
                              num_secondary_samples, direct=False):
        """Reshape the queried radiance and attach it, the per-ray opacity and
        the BRDF correction (learned from `feature`, or one) to the lobe's
        sample records."""
        shape = self._radiance_shape(num_secondary_samples, direct)
        rgb = torch.nan_to_num(rgb).reshape(shape)
        if self.stopgrad_rgb:
            rgb = rgb.detach()
        rgb_ns = torch.nan_to_num(rgb_ns).reshape(shape)
        ref_samples = {k: v.reshape(rgb.shape[0], -1, v.shape[-1]) for k, v in ref_samples.items()}
        # The active closure repeats the occlusion over the channels: keep one.
        occ_acc = ref_sampler_results[-1]["acc"].reshape(rgb.shape[0], rgb.shape[1], -1)[..., :1]
        correction = (self.get_brdf_correction(feature, ref_samples, num_secondary_samples)
                      if self.use_brdf_correction
                      else torch.ones_like(ref_samples["local_lightdirs"][..., :2]))
        ref_samples.update(radiance_in=rgb, indirect_occ=occ_acc, radiance_in_no_stopgrad=rgb_ns,
                           brdf_correction=correction)
        return ref_samples

    def _integrate_lobe(self, material_type, material, ref_samples, ref_sampler_results, direct,
                        sh):
        """MC-integrate one lobe's queried samples and restore the point dims
        (and the bins axis of a transient indirect lobe)."""
        kw = dict(use_diffuseness=self.use_diffuseness, use_mirrorness=self.use_mirrorness,
                  use_specular_albedo=self.use_specular_albedo, max_radiance=self.rgb_max)
        if self.config.use_transient:
            integrated = render_utils.transient_integrate_reflect_rays(
                material_type, self.use_brdf_correction, material, ref_samples, direct=direct, **kw)
        else:
            integrated = render_utils.integrate_reflect_rays(
                material_type, self.use_brdf_correction, material, ref_samples, **kw)
        if direct and self.use_active:
            integrated["occ"] = ref_sampler_results[-1]["occ"]
        lead = tuple(sh[:-1]) if direct or not self.config.use_transient else tuple(sh[:-1]) + (-1,)
        return {k: v.reshape(lead + (v.shape[-1],)) for k, v in integrated.items()
                if v is not None}

    def _store_lobe(self, outputs, mode, comp, ref_rays, ref_samples, ref_sampler_results,
                    integrated, stopgrad_weight):
        outputs[f"ref_rays_{mode}_{comp}"] = ref_rays
        outputs[f"ref_samples_{mode}_{comp}"] = ref_samples
        outputs[f"ref_sampler_results_{mode}_{comp}"] = ref_sampler_results
        for k, val in integrated.items():
            # Degenerate MC draws (grazing GGX half-vectors) can yield
            # isolated non-finite samples; they are zeroed, not propagated.
            outputs[f"{mode}_{comp}_{k}"] = stopgrad_with_weight(torch.nan_to_num(val),
                                                                 stopgrad_weight)

    def _secondary_light(self, light_sampler_results):
        """The light sampler's results that sample secondary directions:
        detached unless stopgrad_light is off."""
        if light_sampler_results is None or not self.stopgrad_light:
            return light_sampler_results
        return {k: v.detach() for k, v in light_sampler_results.items()}

    def _process_indirect_lobes_fused(self, rng, rays, feature, sampler_results, material,
                                      num_secondary_samples, radiance_cache_fn, train_frac, train,
                                      light_sampler_results, integrated_outputs, mesh=None):
        """Both indirect lobes through one radiance query: each keeps its own
        samplers and MIS pdfs, their secondary rays are concatenated along the
        secondary axis and traced in a single cache forward, and the results
        split back per lobe and integrate as two separate queries would."""
        sizes = self._lobe_sizes(num_secondary_samples)
        lobes = [(comp, sizes[comp], self._lobe_samplers(comp, train), f"microfacet_{comp}")
                 for comp in ("specular", "diffuse")]
        ns = [n for _, n, _, _ in lobes]
        sh = sampler_results["points"].shape
        # Ray directions take no gradient into the material under
        # stopgrad_material, nor into the light sampler under stopgrad_light.
        material_sec = self._secondary_material(material)
        light_sec = self._secondary_light(light_sampler_results)

        key, rng = torchutil.random_split(rng)
        sampled = [self._sample_lobe_rays(key, rays, sampler_results, material_sec, light_sec,
                                          samplers, n, train_frac, mesh)
                   for _, n, samplers, _ in lobes]
        n_total = sum(ns)
        fused_rays = _fuse_lobe_rays(sampled[0][0], sampled[1][0], ns)
        key, rng = torchutil.random_split(rng)
        rgb, rgb_ns, srs = radiance_cache_fn(key, fused_rays)
        shape = self._radiance_shape(n_total, direct=False)
        rgb, rgb_ns = rgb.reshape(shape), rgb_ns.reshape(shape)

        offset = 0
        for (comp, n, _, material_type), (rr, rs) in zip(lobes, sampled):
            lo, hi = offset, offset + n
            offset = hi
            srs_l = [{k: v[:, lo:hi] if isinstance(v, torch.Tensor) else v
                      for k, v in level.items()} for level in srs]
            ref_samples = self._attach_lobe_radiance(rgb[:, lo:hi], rgb_ns[:, lo:hi], rs, srs_l,
                                                     feature, n)
            integrated = self._integrate_lobe(material_type, material, ref_samples, srs_l, False,
                                              sh)
            self._store_lobe(integrated_outputs, "indirect", comp, rr, ref_samples, srs_l,
                             integrated, self.stopgrad_indirect_weight)

    def _process_indirect_lobes(self, rng, rays, feature, sampler_results, material,
                                num_secondary_samples, radiance_fn, train_frac, train,
                                light_sampler_results, outputs, mesh=None, last=None):
        """The indirect lobes one at a time (JAX's per-lobe path): each lobe
        with samples draws its secondary rays (or takes those of an earlier
        estimate, `last`), queries them through `radiance_fn` and
        integrates. A lobe without samples adds nothing, its outputs left
        to the integration strategy's 0.0."""
        sh = sampler_results["points"].shape
        material_sec = self._secondary_material(material)
        light_sec = self._secondary_light(light_sampler_results)
        for comp, n in self._lobe_sizes(num_secondary_samples).items():
            if n == 0:
                continue
            key, rng = torchutil.random_split(rng)
            if last is None:
                ref_rays, ref_samples = self._sample_lobe_rays(
                    key, rays, sampler_results, material_sec, light_sec,
                    self._lobe_samplers(comp, train), n, train_frac, mesh)
            else:
                ref_rays = last[f"ref_rays_indirect_{comp}"]
                ref_samples = dict(last[f"ref_samples_indirect_{comp}"])
            key, rng = torchutil.random_split(rng)
            rgb, rgb_ns, srs = radiance_fn(key, ref_rays)
            ref_samples = self._attach_lobe_radiance(rgb, rgb_ns, ref_samples, srs, feature, n)
            integrated = self._integrate_lobe(f"microfacet_{comp}", material, ref_samples, srs,
                                              False, sh)
            self._store_lobe(outputs, "indirect", comp, ref_rays, ref_samples, srs, integrated,
                             self.stopgrad_indirect_weight)

    # --- the active light --------------------------------------------------------

    def _lights(self, lights, look, up):
        """The light positions: the learnable light's (detached), or the rays'."""
        if self.config.learnable_light:
            return self.learnable_light.get_lights(lights, look, up).detach()
        return lights

    def _make_active_light_fn(self, sampler_results, rays):
        """Direct lighting along one ray per surface point toward the light:
        the learnable light (or the shader's own power with inverse-square
        falloff, zero outside its cone of ``light_max_angle`` about the
        camera's look direction of `rays`), darkened by the occlusion the
        cache shader stored at the point (its shadow ray, traced there under
        Config.use_occlusions). No
        ray is traced here: JAX clips this ray's far bound at the light, but
        no query reads the clipped ray, so the port does not form it."""
        cfg = self.config

        def active_fn(ref_rays):
            lights = self._lights(ref_rays.lights, ref_rays.vcam_look, ref_rays.vcam_up)
            light_offset = lights - ref_rays.origins
            light_dists = torch.linalg.norm(light_offset, dim=-1, keepdim=True)
            if cfg.learnable_light:
                light_radiance, _ = self.learnable_light(
                    ref_rays.origins, ref_rays.viewdirs, ref_rays.lights, ref_rays.vcam_look,
                    ref_rays.vcam_up, ref_rays.vcam_origins)
            else:
                light_radiance = torch.ones_like(light_dists) * self._light_power()
                if cfg.use_falloff:
                    light_radiance = light_radiance / torch.clamp(light_dists**2, min=1e-5)
                if self.light_max_angle > 0.0:
                    light_dirs = light_offset / torch.clamp(light_dists, min=1e-5)
                    light_radiance = nerf_shader.cone_light(light_radiance, light_dirs,
                                                            rays.vcam_look, self.light_max_angle)
            if cfg.light_zero:
                light_radiance = torch.where(light_dists < cfg.light_near,
                                             torch.zeros_like(light_radiance), light_radiance)
            occ = sampler_results["occ"][..., :1].reshape(ref_rays.origins[..., :1].shape)
            occ_rgb = occ.repeat_interleave(self.num_rgb_channels, dim=-1)
            light_radiance = light_radiance * (1.0 - occ)
            rgb = light_radiance.repeat_interleave(self.num_rgb_channels, dim=-1)
            if cfg.material_loss_radius < float("inf"):
                rgb = stopgrad_with_weight(rgb, self._radius_mask(ref_rays.origins))
            rgb = torch.clamp(rgb, min=0.0)
            return rgb, rgb, [{"occ": occ_rgb, "acc": occ_rgb}]

        return active_fn

    def _process_direct_lobes(self, rng, rays, feature, sampler_results, material, train_frac,
                              integrated_outputs, mesh=None):
        """The direct specular and diffuse lobes: one ray per surface point
        toward the light (the active sampler), lit once and integrated under
        each lobe. Its uniforms are drawn, though the sampler ignores them."""
        sh = sampler_results["points"].shape
        means = sampler_results["means"]
        lights = self._lights(rays.lights, rays.vcam_look, rays.vcam_up)
        light_sec = self._secondary_light(
            {"origins": means[..., None, :],
             "lights": lights[..., None, None, :] * torch.ones_like(means[..., None, :])})
        material_sec = self._secondary_material(material)
        ref_rays, ref_samples = self._sample_lobe_rays(
            rng, rays, sampler_results, material_sec, light_sec, self._active_samplers, 1,
            train_frac, mesh)
        rgb, rgb_ns, srs = self._make_active_light_fn(sampler_results, rays)(ref_rays)
        ref_samples = self._attach_lobe_radiance(rgb, rgb_ns, ref_samples, srs, feature, 1,
                                                 direct=True)
        for comp in ("specular", "diffuse"):
            integrated = self._integrate_lobe(f"microfacet_{comp}", material, ref_samples, srs,
                                              True, sh)
            self._store_lobe(integrated_outputs, "direct", comp, ref_rays, ref_samples, srs,
                             integrated, self.stopgrad_direct_weight)

    def get_outgoing_radiance(self, rng, rays, feature, sampler_results, material,
                              num_secondary_samples, radiance_cache_fn, train_frac=1.0, train=True,
                              light_sampler_results=None, last_integrated_outputs=None,
                              mesh=None, env_map_fn=None):
        """All lobes of the outgoing-radiance estimate, combined per the
        integration strategy. last_integrated_outputs: an earlier estimate
        whose indirect lobes' rays and sample records this one reuses.
        mesh: fresh secondary rays start at their near point. Fresh split
        lobes that both have samples share one radiance query (not under
        the environment map); otherwise the lobes run one at a time.
        env_map_fn: lights the direct lobes of a passive shader under
        ``use_env_map`` along the indirect lobes' rays."""
        out = {k: 0.0 for k in self._integration_strategy}
        key, rng = torchutil.random_split(rng)
        if self.use_indirect:
            args = (key, rays, feature, sampler_results, material, num_secondary_samples,
                    radiance_cache_fn, train_frac, train, light_sampler_results, out, mesh)
            if (last_integrated_outputs is None and self.separate_integration_diffuse_specular
                    and not self.use_env_map
                    and min(self._lobe_sizes(num_secondary_samples).values()) > 0):
                self._process_indirect_lobes_fused(*args)
            else:
                # Only the SLF variate reuses rays, and only a steady cache has
                # an SLF memory: the direct lobes (the transient shader's)
                # never do.
                self._process_indirect_lobes(*args, last=last_integrated_outputs)
        if self.use_active:
            key, rng = torchutil.random_split(rng)
            self._process_direct_lobes(key, rays, feature, sampler_results, material, train_frac,
                                       out, mesh)
        elif self.use_env_map:
            key, rng = torchutil.random_split(rng)
            self._process_env_map_lobes(key, feature, sampler_results, material,
                                        num_secondary_samples, env_map_fn, out)
        for output_key, (sub_keys, scale) in self._integration_strategy.items():
            if "indirect" in output_key and not self.use_indirect:
                continue
            total = 0.0
            for sub_key, dims in sub_keys:
                if "indirect" in sub_key and not self.use_indirect:
                    continue
                val = out.get(sub_key, 0.0)
                if isinstance(val, torch.Tensor) and dims:
                    val = val.sum(dim=dims)
                total = total + val
            out[output_key] = total * scale
        return out

    def _process_env_map_lobes(self, rng, feature, sampler_results, material,
                               num_secondary_samples, env_map_fn, outputs):
        """The direct lobes of the passive shader under ``use_env_map``:
        each indirect lobe's rays and sample records again, lit by the
        environment map where that lobe's query left them transparent."""
        sh = sampler_results["points"].shape
        for comp, n in self._lobe_sizes(num_secondary_samples).items():
            if n == 0:
                continue
            ref_rays = outputs[f"ref_rays_indirect_{comp}"]
            ref_samples = dict(outputs[f"ref_samples_indirect_{comp}"])
            key, rng = torchutil.random_split(rng)
            rgb, rgb_ns, srs = env_map_fn(key, ref_rays,
                                          outputs[f"ref_sampler_results_indirect_{comp}"])
            ref_samples = self._attach_lobe_radiance(rgb, rgb_ns, ref_samples, srs, feature, n,
                                                     direct=True)
            integrated = self._integrate_lobe(f"microfacet_{comp}", material, ref_samples, srs,
                                              True, sh)
            self._store_lobe(outputs, "direct", comp, ref_rays, ref_samples, srs, integrated,
                             self.stopgrad_direct_weight)

    # The estimates the SLF variate takes as the cache's minus the memory's.
    _VARIATE_KEYS = ("radiance_out", "diffuse_radiance_out", "specular_radiance_out",
                     "direct_radiance_out", "indirect_radiance_out", "irradiance")

    def _integrate_slf_variate(self, rng, rays, feature, sampler_results, material,
                               radiance_cache_fn, surface_lf_fn, train_frac, train,
                               light_sampler_results, env_map_fn=None):
        """The SLF control variate: the cache's estimate minus the memory's
        on the same secondary rays, at ``num_secondary_samples_diff``; every
        output of each estimate also under ``<key>_cache`` / ``<key>_slf``."""
        n = self.num_secondary_samples_diff if train else self.render_num_secondary_samples_diff
        kw = dict(train_frac=train_frac, train=train, light_sampler_results=light_sampler_results,
                  env_map_fn=env_map_fn)
        key, rng = torchutil.random_split(rng)
        cache_out = self.get_outgoing_radiance(key, rays, feature, sampler_results, material, n,
                                               radiance_cache_fn, **kw)
        key, rng = torchutil.random_split(rng)
        slf_out = self.get_outgoing_radiance(key, rays, feature, sampler_results, material, n,
                                             surface_lf_fn, last_integrated_outputs=cache_out, **kw)
        final = dict(cache_out)
        for k in self._VARIATE_KEYS:
            if k in cache_out and k in slf_out:
                final[k] = cache_out[k] - slf_out[k]
        for f in list(final):
            final[f + "_cache"] = cache_out.get(f)
            final[f + "_slf"] = slf_out.get(f)
        return final

    # --- top level ---------------------------------------------------------------

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           radiance_cache=None, light_sampler_results=None, material_only=False,
                           slf_variate=False, secondary_proposal_grad=True, mesh=None, **kwargs):
        """The shader's outputs at the samples. material_only: the material
        heads alone, as the full pass outputs them (radius-masked), and no
        secondary ray traced (the perturbed pass of material_smoothness,
        which reads nothing else). secondary_proposal_grad=False: the
        secondary rays' proposal levels run without a graph, which would
        otherwise hold their activations through the step (the train step
        asks for it where no loss reads them; JAX's compiler drops them).
        slf_variate: the SLF variate's estimate (with an SLF memory; without
        one, the cache's estimate as the full pass makes it); otherwise a
        shader with the memory queries the memory alone. mesh: the secondary
        rays' cache queries take the mesh shortcut, and, outside the SLF
        variate (as in JAX), fresh secondary rays start at their near point."""
        del kwargs
        key, rng = torchutil.random_split(rng)
        feature, material = self._predict_material_and_feature(key, rays, sampler_results, train)
        if material_only:
            outputs = {"material_" + k: v for k, v in material.items()}
            self._apply_radius_mask(outputs, sampler_results["means"])
            return outputs
        emission, residual_albedo = self._emission_and_residual_albedo(feature, material,
                                                                       train_frac)
        # JAX writes the residual albedo as material_albedo here, which its
        # _finalize_outputs then overwrites with the material's albedo.
        outputs = {"material_residual_albedo": residual_albedo}
        radiance_cache_fn = self._make_radiance_cache_fn(radiance_cache, sampler_results,
                                                         train_frac, train, secondary_proposal_grad,
                                                         mesh)
        surface_lf_fn = (self._make_surface_lf_fn(radiance_cache, sampler_results, train_frac,
                                                  train)
                         if self.use_surface_light_field else None)
        env_map_fn = (self._make_env_map_fn(radiance_cache, train_frac, train)
                      if self.use_env_map and not self.use_active else None)
        key, rng = torchutil.random_split(rng)
        if slf_variate and self.use_surface_light_field:
            integrated = self._integrate_slf_variate(
                key, rays, feature, sampler_results, material, radiance_cache_fn, surface_lf_fn,
                train_frac, train, light_sampler_results, env_map_fn)
        else:
            integrated = self.get_outgoing_radiance(
                key, rays, feature, sampler_results, material,
                self.num_secondary_samples if train else self.render_num_secondary_samples,
                surface_lf_fn if self.use_surface_light_field else radiance_cache_fn,
                train_frac=train_frac, train=train, light_sampler_results=light_sampler_results,
                mesh=mesh, env_map_fn=env_map_fn)
        final_rgb = integrated["direct_radiance_out" if self.config.use_transient
                               else "radiance_out"]
        if self.use_diffuse_emission:
            final_rgb = final_rgb + emission
        elif self.use_residual_albedo:
            final_rgb = final_rgb + integrated["irradiance"] * residual_albedo
        self._finalize_outputs(rays, outputs, integrated, final_rgb, material, emission,
                               sampler_results)
        return outputs

    def _emission_and_residual_albedo(self, feature, material, train_frac):
        """The diffuse emission (its gradient eased by the variate weights
        over the emission window) and the residual albedo from their heads;
        zeros where a head is off."""
        emission = torch.zeros_like(material["albedo"])
        residual_albedo = torch.zeros_like(material["albedo"])
        if self.use_diffuse_emission:
            emission = self.rgb_emission_activation(
                self.rgb_premultiplier * self.rgb_diffuse_emission_layer(feature)
                + self.rgb_bias_emission)
            w = (float(np.clip(np.float32(train_frac) / np.float32(self.emission_window_frac),
                               0.0, 1.0))
                 if self.emission_window_frac > 0.0 else 1.0)
            ew = ((1.0 - w) * self.emission_variate_weight_start
                  + w * self.emission_variate_weight_end)
            emission = emission * ew + emission.detach() * (1.0 - ew)
        if self.use_residual_albedo:
            residual_albedo = self.rgb_residual_albedo_activation(
                self.rgb_premultiplier * self.rgb_residual_albedo_layer(feature)
                + self.rgb_bias_residual_albedo)
        return emission, residual_albedo

    def _finalize_outputs(self, rays, outputs, integrated, final_rgb, material, emission,
                          sampler_results):
        for k in material:
            outputs["material_" + k] = material[k]
        outputs["lighting_emission"] = emission
        outputs["lighting_irradiance"] = integrated["irradiance"].reshape(material["albedo"].shape)
        if integrated.get("irradiance_cache") is not None:
            # The SLF variate's cache-side irradiance.
            outputs["irradiance_cache"] = integrated["irradiance_cache"].reshape(
                material["albedo"].shape)
        if "occ" not in sampler_results:
            outputs["occ"] = integrated["occ"] if self.use_active else torch.zeros_like(final_rgb)
        outputs["rgb"] = final_rgb
        outputs["direct_diffuse_rgb"] = integrated["direct_diffuse_radiance_out"] + emission
        outputs["direct_specular_rgb"] = integrated["direct_specular_radiance_out"]
        outputs["direct_rgb"] = integrated["direct_radiance_out"]
        if self.config.use_transient and self.use_indirect:
            tid, tis = render_utils.zero_invalid_bins(
                integrated["indirect_diffuse_radiance_out"],
                integrated["indirect_specular_radiance_out"], rays, sampler_results["means"],
                self.config)
            outputs["transient_indirect"] = tid + tis
            outputs["transient_indirect_diffuse"] = tid
            outputs["transient_indirect_specular"] = tis
        elif self.config.use_transient:
            direct = outputs["direct_diffuse_rgb"]
            for k in ("transient_indirect", "transient_indirect_diffuse",
                      "transient_indirect_specular"):
                outputs[k] = torch.zeros(direct.shape[:-1] + (self.config.n_bins,
                                                              direct.shape[-1]),
                                         dtype=direct.dtype, device=direct.device)
        if self.use_indirect:
            outputs["indirect_diffuse_rgb"] = integrated["indirect_diffuse_radiance_out"]
            outputs["indirect_specular_rgb"] = integrated["indirect_specular_radiance_out"]
            outputs["indirect_rgb"] = integrated["indirect_radiance_out"]
            outputs["indirect_occ"] = integrated["indirect_occ"]
        else:
            for k in ("indirect_diffuse_rgb", "indirect_specular_rgb", "indirect_rgb",
                      "indirect_occ"):
                outputs[k] = torch.zeros_like(outputs["direct_rgb"])
        outputs["diffuse_rgb"] = integrated["diffuse_radiance_out"]
        outputs["specular_rgb"] = integrated["specular_radiance_out"]
        for f in integrated:
            if f.startswith("ref_"):
                outputs[f] = integrated[f]
        means = sampler_results["means"]
        outputs["ray_dists"] = torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1,
                                                 keepdim=True)
        if self.use_active:
            lights = self._lights(rays.lights, rays.vcam_look, rays.vcam_up)
            outputs["light_dists"] = torch.linalg.norm(lights[..., None, :] - means, dim=-1,
                                                       keepdim=True)
        self._apply_radius_mask(outputs, means)

    def _apply_radius_mask(self, outputs, means):
        """No gradient from surface points outside the scene radius; a
        time-binned output gets the mask before its bins axis."""
        mask = self._radius_mask(means)
        for k, v in outputs.items():
            if not isinstance(v, torch.Tensor):
                continue
            if self.config.use_transient and v.dim() == mask.dim() + 1:
                outputs[k] = stopgrad_with_weight(v, mask[..., None, :])
            elif v.dim() == mask.dim():
                outputs[k] = stopgrad_with_weight(v, mask)


@gin.configurable
class MaterialMLP(BaseMaterialMLP):
    """Steady material shader, passive path."""

    def _check_variant(self, config):
        self._require(use_active=False)
        if config.learnable_light or config.use_transient:
            raise NotImplementedError("learnable lights and transient materials take "
                                      "TransientMaterialMLP")
        if not self.use_indirect:
            raise NotImplementedError(_NO_IRRADIANCE_GAP.format("MaterialMLP.use_indirect=False"))
        for train in (True, False):
            n = self.num_secondary_samples if train else self.render_num_secondary_samples
            if self._lobe_sizes(n)["diffuse"] == 0:
                raise NotImplementedError(_NO_IRRADIANCE_GAP.format(
                    f"MaterialMLP.diffuse_sample_fraction={self.diffuse_sample_fraction} over {n} "
                    "secondary samples (a diffuse lobe without samples)"))

    def _build_integration_strategy(self):
        return _steady_integration_strategy(self.use_active)


class CacheStageLight(nn.Module):
    """The transient material shader's light alone: its ``light_power``
    (with ``optimize_light``) and its ``learnable_light``, with the
    ``TransientMaterialMLP`` bindings and `shader_params` (the model's
    ``shader_params``, which override them). A cache stage
    (``use_material=False``) under ``Config.learnable_light`` reads the light
    from its material model's shader, in the cache shader (a shared light
    power) and in the integrator (the transient shift and dark level); the
    JAX material shader creates exactly these parameters there, its
    ``light_power`` in its setup and the learnable light's at the first
    read."""

    def __init__(self, config, shader_params=None):
        super().__init__()
        fields = {**gin.get_bindings("TransientMaterialMLP"), **dict(shader_params or {})}
        if fields.get("optimize_light", TransientMaterialMLP.optimize_light):
            bias = fields.get("light_power_bias", TransientMaterialMLP.light_power_bias)
            self.light_power = nn.Parameter(torch.full((1,), float(bias)))
        self.learnable_light = light_sampler_lib.LightSourceMap(config=config)


@gin.configurable
class TransientMaterialMLP(BaseMaterialMLP):
    """Time-resolved material shader (InvProp), active path."""

    use_active = True

    def _check_variant(self, config):
        if not self.use_active:
            # A reference gap: JAX's passive transient material shader runs
            # no direct lobe, and its step raises at the first read of what
            # the lobe would have filled.
            raise NotImplementedError(
                "TransientMaterialMLP.use_active=False: the JAX package cannot run this "
                "material stage: " + (
                    "no direct lobe runs, so the integration strategy's direct_* sums stay "
                    "the float 0.0 that material_shader.py:1065 seeds and ops/render.py:445 "
                    "raises AttributeError: 'float' object has no attribute 'shape'"
                    if self.use_indirect else
                    "material_shader.py:1295 reshapes integrated['irradiance'], the float "
                    "0.0, and raises AttributeError: 'float' object has no attribute "
                    "'reshape'"))
        if self.use_indirect and not self.separate_integration_diffuse_specular:
            raise NotImplementedError(
                "TransientMaterialMLP.separate_integration_diffuse_specular=False is a reference "
                "gap: the JAX shader then fills no indirect specular lobe, whose output stays the "
                "float 0.0, and the transient material integrator raises AttributeError: 'float' "
                "object has no attribute 'shape' (ops/render.py:445)")
        if self.use_indirect and self._lobe_sizes(self.num_secondary_samples)["diffuse"] == 0:
            raise NotImplementedError(
                f"TransientMaterialMLP.diffuse_sample_fraction={self.diffuse_sample_fraction} "
                "(a diffuse lobe without samples) is a reference gap: the JAX shader's "
                "zero_invalid_bins reads the diffuse lobe's output, the float 0.0, and raises "
                "AttributeError: 'float' object has no attribute 'shape' "
                "(ops/render_utils.py:1261)")
        if not config.use_transient:
            raise ValueError("TransientMaterialMLP needs Config.use_transient")
        if config.sl_relight:
            raise NotImplementedError(shading.SL_RELIGHT_GAP)

    def _build_integration_strategy(self):
        return _transient_integration_strategy()
