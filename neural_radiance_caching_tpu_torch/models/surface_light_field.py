"""Surface light field MLP (counterpart of ``models/surface_light_field.py``).

Ported: the configuration the cache shader uses on the slice, a
view-conditioned decoder over the shader's bottleneck and the (integrated)
directional encoding of the query direction. The distance head, reflectance
grid, point encodings and light conditioning are not ported yet and raise.
"""

from __future__ import annotations

import torch

from neural_radiance_caching_tpu_torch.models import shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, softplus
from neural_radiance_caching_tpu_torch.ops import coord, ref_utils


def _ide_dim(deg_view):
    return 2 * sum(2**i + 1 for i in range(deg_view))


class SurfaceLightFieldMLP(shading.BaseShader):
    use_bottleneck = True
    use_shader_bottleneck = False
    use_directional_enc = False
    use_ide = False
    use_origins = False
    use_lights = True
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

    def __init__(self, config=None, shader_bottleneck_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._require(use_bottleneck=False, use_shader_bottleneck=True, use_origins=False,
                      use_lights=False, use_points=False, use_sphere_points=False,
                      use_far_field_points=False, use_distance_prediction=False,
                      use_density_prediction=False, use_indirect=False,
                      use_reflectance_grid=False, rotate_illumination=False)
        if config is not None and config.multi_illumination:
            raise NotImplementedError("multi-illumination is not ported yet")
        if self.use_ide:
            self.dir_enc_fn = ref_utils.generate_ide_fn(self.deg_view)
            dir_dim = _ide_dim(self.deg_view)
        else:
            self.dir_enc_fn = lambda d, _: coord.pos_enc(d, 0, self.deg_view, True)
            dir_dim = 3 + 6 * self.deg_view
        in_dim = shader_bottleneck_dim + (dir_dim if self.use_directional_enc else 0)
        names = [f"layer_{i}" for i in range(self.net_depth_viewdirs - 1)] + ["layer_bottleneck"]
        widths = [self.net_width_viewdirs] * (self.net_depth_viewdirs - 1) + [self.bottleneck_viewdirs]
        self.view_dependent_layers = SkipMLP(in_dim, widths, self.skip_layer_dir,
                                             self.net_activation, self.compute_dtype, names=names)
        out_dim = self.view_dependent_layers.out_dim
        self.output_rgba_layer = Dense(out_dim, self.num_rgb_channels + 1, self.compute_dtype)
        self.output_ambient_rgb_layer = Dense(out_dim, self.num_rgb_channels, self.compute_dtype)

    def forward(self, rng, rays, sampler_results, origins, refdirs, roughness=None,
                shader_bottleneck=None, train=True, train_frac=1.0, dist_only=False, **kwargs):
        del rng, rays, sampler_results, train, train_frac, kwargs
        if dist_only:
            raise NotImplementedError("dist_only queries are not ported yet")
        outputs = {}
        bottleneck = shader_bottleneck
        feats = [shader_bottleneck]
        unit = torch.ones_like(bottleneck[..., 0:1])
        s_distances = distances = env_alpha = torch.zeros_like(unit)
        env_rgb = torch.zeros_like(bottleneck[..., 0:3])
        ref_weights = unit
        s_distances = s_distances.mean(dim=-1, keepdim=True)
        if self.use_directional_enc:
            feats.append(self.dir_enc_fn(refdirs, roughness))
        x = self.view_dependent_layers(torch.cat(feats, dim=-1))

        raw_rgba = self.output_rgba_layer(x)
        rgb = self.rgb_activation(self.rgb_premultiplier * raw_rgba[..., :-1] + self.rgb_bias)
        alpha = torch.clamp(self.alpha_activation(raw_rgba[..., -1:] + self.alpha_bias), 0.0, 1.0)
        ambient_rgb = self.ambient_rgb_activation(
            self.output_ambient_rgb_layer(x) + self.ambient_rgb_bias)

        outputs["incoming_rgb"] = torch.clamp(rgb, 0.0, self.rgb_max)
        outputs["incoming_ambient_rgb"] = torch.clamp(ambient_rgb, 0.0, self.ambient_rgb_max)
        outputs["incoming_alpha"] = alpha
        outputs["incoming_weights"] = ref_weights
        outputs["incoming_s_dist"] = s_distances
        outputs["incoming_dist"] = distances
        outputs["incoming_env_rgba"] = torch.cat([env_rgb, env_alpha], dim=-1)
        outputs["incoming_acc"] = ref_weights.sum(dim=-1)
        return outputs
