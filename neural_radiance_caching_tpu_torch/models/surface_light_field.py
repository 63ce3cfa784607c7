"""Surface light field MLP (counterpart of ``models/surface_light_field.py``).

Ported: a view-conditioned decoder over the shader's bottleneck
(``use_shader_bottleneck``) and/or the zero bottleneck of an SLF without a
grid (``use_bottleneck``), and the (integrated) directional encoding of the
query direction; with ``use_lights`` the light position's encoding
conditions a second, lit trunk that feeds the rgba head, while the first
feeds the ambient head. With ``use_indirect`` (the transient SLF) the rgb
head emits n_bins x 3 time-binned channels. The cache's surface light
field memory (``NeRFModel.surface_lf_mem``) is this MLP at its defaults: the
zero bottleneck and the light position's encoding, queried at one point per
ray. The distance head, reflectance grid, point and origin encodings and
``dist_only`` queries are not ported yet and raise; ``raydist_fn`` (a
``(fn, fn_inv, kwargs)`` ray warp) and ``use_env_alpha`` are read by the
distance head only.
"""

from __future__ import annotations

import torch

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, clamp, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math, ref_utils


def _ide_dim(deg_view):
    return 2 * sum(2**i + 1 for i in range(deg_view))


@gin.configurable
class SurfaceLightFieldMLP(shading.BaseShader, unported=dict(
        deg_origins=4, use_points_ide=False, deg_points=4, deg_sphere_points=4,
        sphere_radius=5.0, use_point_offsets=False, point_offset_scale=0.25,
        point_offset_bias=-3.0, reflectance_grid_representation="ngp",
        reflectance_grid_params=None, use_roughness=False, roughness_scale=0.001,
        per_ref_feature_output=False, num_light_features=64,
        multiple_illumination_outputs=True)):
    """View-conditioned incoming radiance (see the module docstring)."""

    window_points_frac = 0.0  # declared in JAX, read by nothing there

    # Read by the distance and density heads only (use_distance_prediction,
    # use_density_prediction).
    net_depth_distance = 1
    net_width_distance = 128
    skip_layer_distance = 4
    deg_view_distance = 2
    use_distance_ide = False
    use_sorted_distances = False
    net_depth_density = 2
    net_width_density = 64
    skip_layer_density = 2
    density_activation = staticmethod(math.safe_exp)
    density_bias = -1.0
    density_noise = 0.0
    num_distance_samples = 1
    num_far_samples = 0
    distance_far_field = float("inf")
    distance_scale = 1.0
    distance_bias = -2.0
    use_uniform_distance = False
    use_uniform_loss = False
    use_uniform_grid = True
    use_voxel_grid = False
    voxel_start = 0.0
    voxel_end = 10.0
    use_bottleneck = True
    use_shader_bottleneck = False
    use_directional_enc = False
    use_ide = False
    use_origins = False
    use_lights = True
    deg_lights = 2
    use_points = False
    use_sphere_points = False
    use_far_field_points = False
    use_env_alpha = False
    net_depth_viewdirs = 1
    net_width_viewdirs = 128
    bottleneck_viewdirs = 128
    skip_layer_dir = 4
    deg_view = 4
    use_distance_prediction = False
    use_density_prediction = False
    alpha_bias = 2.0
    alpha_activation = staticmethod(torch.sigmoid)
    distance_near = 1e-3
    distance_far = 1e6
    use_indirect = False
    use_reflectance_grid = False
    rotate_illumination = False
    rgb_max = float("inf")
    ambient_rgb_max = float("inf")
    ambient_rgb_activation = staticmethod(softplus)
    ambient_rgb_bias = -1.0
    raydist_fn = None
    ref_warp_fn = None  # read by the distance head only
    use_illumination_feature = False  # read with multi_illumination only

    def __init__(self, config=None, shader_bottleneck_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._require(use_grid=False, use_origins=False, use_points=False, use_sphere_points=False,
                      use_far_field_points=False, use_distance_prediction=False,
                      use_density_prediction=False,
                      use_reflectance_grid=False, rotate_illumination=False)
        if config is not None and config.multi_illumination:
            raise NotImplementedError("multi-illumination is not ported yet")
        if self.use_ide:
            self.dir_enc_fn = ref_utils.generate_ide_fn(self.deg_view)
            dir_dim = _ide_dim(self.deg_view)
        else:
            self.dir_enc_fn = lambda d, _: coord.pos_enc(d, 0, self.deg_view, True)
            dir_dim = 3 + 6 * self.deg_view
        # Without a grid the bottleneck is the shader's (use_shader_bottleneck)
        # or 3 zeros.
        bottleneck_dim = shader_bottleneck_dim if self.use_shader_bottleneck else 3
        in_dim = ((bottleneck_dim if self.use_bottleneck else 0)
                  + (shader_bottleneck_dim if self.use_shader_bottleneck else 0)
                  + (dir_dim if self.use_directional_enc else 0))
        names = [f"layer_{i}" for i in range(self.net_depth_viewdirs - 1)] + ["layer_bottleneck"]
        widths = [self.net_width_viewdirs] * (self.net_depth_viewdirs - 1) + [self.bottleneck_viewdirs]
        trunk = lambda d, names: SkipMLP(d, widths, self.skip_layer_dir, self.net_activation,
                                         self.compute_dtype, names=names)
        if self.use_lights:
            self.ambient_view_dependent_layers = trunk(in_dim, ["ambient_" + n for n in names])
            in_dim += 3 + 6 * self.deg_lights
        self.view_dependent_layers = trunk(in_dim, names)
        out_dim = self.view_dependent_layers.out_dim
        rgb_channels = config.num_rgb_channels * (config.n_bins if self.use_indirect else 1)
        self.output_rgba_layer = Dense(out_dim, rgb_channels + 1, self.compute_dtype)
        ambient_dim = (self.ambient_view_dependent_layers.out_dim if self.use_lights
                       else out_dim)
        self.output_ambient_rgb_layer = Dense(ambient_dim, config.num_rgb_channels,
                                              self.compute_dtype)

    def forward(self, rng, rays, sampler_results, origins, refdirs, roughness=None,
                shader_bottleneck=None, train=True, train_frac=1.0, dist_only=False, **kwargs):
        del rng, sampler_results, train, train_frac, kwargs
        if dist_only:
            raise NotImplementedError("dist_only queries are not ported yet")
        outputs = {}
        bottleneck = (shader_bottleneck if self.use_shader_bottleneck
                      else torch.zeros_like(refdirs))
        feats = []
        if self.use_bottleneck:
            feats.append(bottleneck)
        if self.use_shader_bottleneck:
            feats.append(shader_bottleneck)
        unit = torch.ones_like(bottleneck[..., 0:1])
        s_distances = distances = env_alpha = torch.zeros_like(unit)
        env_rgb = torch.zeros_like(bottleneck[..., 0:3])
        ref_weights = unit
        s_distances = s_distances.mean(dim=-1, keepdim=True)
        if self.use_directional_enc:
            feats.append(self.dir_enc_fn(refdirs, roughness))
        x = torch.cat(feats, dim=-1)
        if self.use_lights:
            ambient_x = self.ambient_view_dependent_layers(x)
            origins = origins.reshape(refdirs.shape[:-2] + (-1, 3)) * torch.ones_like(refdirs)
            light_pos = rays.lights[..., None, :] * torch.ones_like(origins)
            if self.warp_fn is not None:
                light_pos = self.warp_fn(light_pos)
            x = self.view_dependent_layers(
                torch.cat([x, coord.pos_enc(light_pos, 0, self.deg_lights, True)], dim=-1))
        else:
            x = ambient_x = self.view_dependent_layers(x)

        raw_rgba = self.output_rgba_layer(x)
        rgb = self.rgb_activation(self.rgb_premultiplier * raw_rgba[..., :-1] + self.rgb_bias)
        alpha = torch.clamp(self.alpha_activation(raw_rgba[..., -1:] + self.alpha_bias), 0.0, 1.0)
        ambient_rgb = self.ambient_rgb_activation(
            self.output_ambient_rgb_layer(ambient_x) + self.ambient_rgb_bias)

        outputs["incoming_rgb"] = clamp(rgb, 0.0, self.rgb_max)
        outputs["incoming_ambient_rgb"] = torch.clamp(ambient_rgb, 0.0, self.ambient_rgb_max)
        outputs["incoming_alpha"] = alpha
        outputs["incoming_weights"] = ref_weights
        outputs["incoming_s_dist"] = s_distances
        outputs["incoming_dist"] = distances
        outputs["incoming_env_rgba"] = torch.cat([env_rgb, env_alpha], dim=-1)
        outputs["incoming_acc"] = ref_weights.sum(dim=-1)
        return outputs


@gin.configurable
class TransientSurfaceLightFieldMLP(SurfaceLightFieldMLP):
    """The transient cache shader's SLF: time-binned incoming radiance."""

    use_indirect = True
