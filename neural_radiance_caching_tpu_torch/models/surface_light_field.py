"""Surface light field MLP (counterpart of ``models/surface_light_field.py``).

Ported: a view-conditioned decoder over a bottleneck (the SLF's own hash
grid through its trunk ``layers``, ``use_grid``; else the shader's,
``use_shader_bottleneck``; else 3 zeros), the origins' encoding
(``use_origins``) and the (integrated) directional encoding of the query
direction; with ``use_lights`` the light position's encoding conditions a
second, lit trunk that feeds the rgba head, while the first feeds the
ambient head. With ``use_indirect`` (the transient SLF) the rgb head emits
n_bins x C time-binned channels. The distance head
(``use_distance_prediction``) proposes ``num_distance_samples`` distances
along the query ray (a zero-initialised head decoded into ladder shifts,
blend logits and an env-map RGBA), and the reflectance grid
(``use_reflectance_grid``) is tapped at those points, its features summed
with the softmax blend x range mask x env alpha. The cache's surface light
field memory (``NeRFModel.surface_lf_mem``) is this MLP at its defaults:
the zero bottleneck and the light position's encoding, queried at one
point per ray.

Under ``Config.multi_illumination`` the ray's light index is read: with
``use_illumination_feature`` the illumination embedding ``light_vecs``
joins the features after the bottleneck; the rgba and ambient heads hold
one output per illumination with ``Config.multiple_illumination_outputs``,
and the field ``multiple_illumination_outputs`` picks the ray's slice of
the rgb head alone, as JAX does (the ambient head stays unselected: the
cache shader refuses that configuration, ``nerf_shader.SLF_AMBIENT_GAP``);
with the field ``rotate_illumination`` and ``Config.rotate_illumination``
the query directions turn about +z by the illumination's angle of
``Config.light_rotations``.

The distance head's options: voxel-plane placement (``use_voxel_grid``:
the head's shifts perturb a stack of axis-aligned planes and the samples
sit where the query ray crosses them), sorted distances and the gated
point nudge (``use_point_offsets``); the reflectance grid's options: its
query scaled by the roughness times the distance (``use_roughness``), a
per-point density head compositing the points as a volume
(``use_density_prediction``) and a per-point decode
(``per_ref_feature_output``, which returns the composited rgb, each point's
alpha and no ambient radiance); the points' (integrated) encoding
(``use_points``), the sphere point's (``use_sphere_points``) and the
far-field point along the query direction (``use_far_field_points``). A
query with ``cache_tdist`` also reports those distances in s
(``cache_sdist``), and with ``dist_only`` that alone.

Where JAX itself fails the port raises naming the failure
(``SORTED_NUDGE_GAP``, ``VOXEL_SAMPLES_GAP``, ``NO_POINTS_GAP``).
"""

from __future__ import annotations

import functools

import torch

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import grids, shading
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, clamp, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math, ref_utils, render
from neural_radiance_caching_tpu_torch.utils import torchutil

# The distance head packs, per proposed sample, a block of 8 channels (the
# ladder shift, its gate, the point-nudge gate, one unread channel, the
# blend logit and an xyz nudge); its last 4 channels are the env-map RGBA.
_HEAD_BLOCK = 8
_HEAD_TAIL = 4

SORTED_NUDGE_GAP = (
    "SurfaceLightFieldMLP.use_sorted_distances with use_point_offsets at num_distance_samples={k} "
    "is a reference gap: JAX's _take_along_sample_axis (models/surface_light_field.py:57-72) "
    "indexes each sample's xyz nudge with the sample order, and jnp.take_along_axis fills an "
    "index past 2 with NaN, so the nudged points (:435-443) are NaN for every ray whose order "
    "puts a sample index above 2 there")
VOXEL_SAMPLES_GAP = (
    "SurfaceLightFieldMLP.use_voxel_grid at num_distance_samples={k} is a reference gap: JAX's "
    "_axis_plane_crossings (models/surface_light_field.py:379) reshapes the K shifts into K // 3 "
    "plane triplets and raises TypeError: cannot reshape array")
NO_POINTS_GAP = (
    "SurfaceLightFieldMLP.{field} without use_distance_prediction or use_far_field_points is a "
    "reference gap: the JAX SLF then has no points (models/surface_light_field.py:549) and "
    "raises at {where}")


def _ide_dim(deg_view):
    return 2 * sum(2**i + 1 for i in range(deg_view))


def _unit_fold(s):
    """Reflect an unbounded s back into [0, 1] (a triangle wave)."""
    return 1.0 - torch.abs(torch.remainder(s, 2.0) - 1.0)


@gin.configurable
class SurfaceLightFieldMLP(shading.BaseShader):
    """View-conditioned incoming radiance (see the module docstring)."""

    window_points_frac = 0.0  # declared in JAX, read by nothing there
    distance_far_field = float("inf")  # declared in JAX, read by nothing there
    density_noise = 0.0  # declared in JAX, read by nothing there

    use_points_ide = False
    deg_points = 4
    deg_sphere_points = 4
    sphere_radius = 5.0
    use_point_offsets = False
    point_offset_scale = 0.25
    point_offset_bias = -3.0
    use_roughness = False
    roughness_scale = 0.001
    per_ref_feature_output = False
    net_depth_density = 2
    net_width_density = 64
    skip_layer_density = 2
    density_activation = staticmethod(math.safe_exp)
    density_bias = -1.0
    use_uniform_grid = True
    voxel_start = 0.0
    voxel_end = 10.0

    net_depth_distance = 1
    net_width_distance = 128
    skip_layer_distance = 4
    deg_view_distance = 2
    use_distance_ide = False
    use_sorted_distances = False
    num_distance_samples = 1
    num_far_samples = 0
    distance_scale = 1.0
    distance_bias = -2.0
    use_uniform_distance = False
    use_uniform_loss = False
    use_voxel_grid = False
    use_bottleneck = True
    use_shader_bottleneck = False
    use_directional_enc = False
    use_ide = False
    use_origins = False
    deg_origins = 4
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
    reflectance_grid_representation = "ngp"
    reflectance_grid_params = None
    rotate_illumination = False
    rgb_max = float("inf")
    ambient_rgb_max = float("inf")
    ambient_rgb_activation = staticmethod(softplus)
    ambient_rgb_bias = -1.0
    raydist_fn = None
    ref_warp_fn = None
    num_light_features = 64
    use_illumination_feature = False
    multiple_illumination_outputs = True

    def __init__(self, config=None, shader_bottleneck_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        cd = self.compute_dtype
        if self.rotates_illumination:
            self.register_buffer("light_rotation_matrix", torch.stack(
                [_z_rotation(config.light_rotations[i])
                 for i in range(config.num_illuminations)]), persistent=False)
        if self.use_ide:
            self.dir_enc_fn = ref_utils.generate_ide_fn(self.deg_view)
            dir_dim = _ide_dim(self.deg_view)
        else:
            self.dir_enc_fn = lambda d, _: coord.pos_enc(d, 0, self.deg_view, True)
            dir_dim = 3 + 6 * self.deg_view
        points_dim = 0
        if self.use_points and self.use_points_ide:
            self.points_enc_fn = ref_utils.generate_ide_fn(self.deg_points)
            points_dim = _ide_dim(self.deg_points)
        elif self.use_points:
            self.points_enc_fn = lambda p, _: coord.pos_enc(p, 0, self.deg_points, True)
            points_dim = 3 + 6 * self.deg_points
        origins_dim = 3 + 6 * self.deg_origins
        # The bottleneck: the own grid through the trunk `layers`, the
        # shader's, or 3 zeros.
        if self.grid is not None:
            bottleneck_dim = self._build_trunk(0)
        elif self.use_shader_bottleneck:
            bottleneck_dim = shader_bottleneck_dim
        else:
            bottleneck_dim = 3
        if self.use_distance_prediction:
            if self.use_distance_ide:
                self.dir_enc_fn_distance = ref_utils.generate_ide_fn(self.deg_view_distance)
                dist_dir_dim = _ide_dim(self.deg_view_distance)
            else:
                self.dir_enc_fn_distance = lambda d, _: coord.pos_enc(
                    d, 0, self.deg_view_distance, True)
                dist_dir_dim = 3 + 6 * self.deg_view_distance
            self.distance_layer = SkipMLP(
                bottleneck_dim + origins_dim + dist_dir_dim,
                [self.net_width_distance] * self.net_depth_distance, self.skip_layer_distance,
                self.net_activation, cd)
            # Zero-initialised and without the compute dtype, as in JAX.
            self.distance_output_layer = Dense(
                self.distance_layer.out_dim,
                _HEAD_BLOCK * self.num_distance_samples + _HEAD_TAIL, kernel_init="zeros")
        if self.use_reflectance_grid:
            grid_cls = grids.GRID_REPRESENTATION_BY_NAME[
                self.reflectance_grid_representation.lower()]
            self.reflectance_grid = grid_cls(**dict(self.reflectance_grid_params or {}))
        illum_dim = self._make_light_vecs() if self.reads_illumination_feature else 0
        names = [f"layer_{i}" for i in range(self.net_depth_viewdirs - 1)] + ["layer_bottleneck"]
        widths = [self.net_width_viewdirs] * (self.net_depth_viewdirs - 1) + [self.bottleneck_viewdirs]
        trunk = lambda d, names: SkipMLP(d, widths, self.skip_layer_dir, self.net_activation,
                                         cd, names=names)
        rgb_channels = config.num_rgb_channels * (config.n_bins if self.use_indirect else 1)
        n_out = self.num_illumination_outputs
        if self.decodes_per_point:
            # Each point's reflectance feature through the lit trunk alone.
            self.view_dependent_layers = trunk(self.reflectance_grid.output_dim, names)
            self.output_rgba_layer = Dense(self.view_dependent_layers.out_dim,
                                           rgb_channels * n_out + 1, cd)
        else:
            in_dim = ((origins_dim if self.use_origins else 0)
                      + (bottleneck_dim if self.use_bottleneck else 0) + illum_dim
                      + (shader_bottleneck_dim if self.use_shader_bottleneck else 0)
                      + (self.reflectance_grid.output_dim if self.use_reflectance_grid else 0)
                      + self.num_points * points_dim
                      + (3 + 6 * self.deg_sphere_points if self.use_sphere_points else 0)
                      + (dir_dim if self.use_directional_enc else 0))
            if self.use_lights:
                self.ambient_view_dependent_layers = trunk(in_dim, ["ambient_" + n for n in names])
                in_dim += 3 + 6 * self.deg_lights
            self.view_dependent_layers = trunk(in_dim, names)
            out_dim = self.view_dependent_layers.out_dim
            self.output_rgba_layer = Dense(out_dim, rgb_channels * n_out + 1, cd)
            ambient_dim = (self.ambient_view_dependent_layers.out_dim if self.use_lights
                           else out_dim)
            self.output_ambient_rgb_layer = Dense(ambient_dim, config.num_rgb_channels * n_out,
                                                  cd)
        if self.use_reflectance_grid and self.use_density_prediction:
            self.density_layer = SkipMLP(
                self.reflectance_grid.output_dim,
                [self.net_width_density] * self.net_depth_density, self.skip_layer_density,
                self.net_activation, cd)
            self.output_density_layer = Dense(self.density_layer.out_dim, 1, cd)

    def _check_reference_gaps(self):
        """Raise where JAX fails: at the first query, as JAX builds the
        module and fails there."""
        k = self.num_distance_samples
        has_points = self.use_distance_prediction or self.use_far_field_points
        if self.use_reflectance_grid and not has_points:
            raise NotImplementedError(NO_POINTS_GAP.format(
                field="use_reflectance_grid",
                where="the reflectance grid's query of None (:570)"))
        if self.use_points and not has_points:
            raise NotImplementedError(NO_POINTS_GAP.format(
                field="use_points", where="ref_utils.l2_normalize(None) (:617)"))
        if not self.use_distance_prediction:
            return
        if self.use_sorted_distances and self.use_point_offsets and k > 3:
            raise NotImplementedError(SORTED_NUDGE_GAP.format(k=k))
        if self.use_voxel_grid and k % 3:
            raise NotImplementedError(VOXEL_SAMPLES_GAP.format(k=k))

    @property
    def num_points(self):
        """The points per query: the far-field point, or the proposed ones."""
        return 1 if self.use_far_field_points else self.num_distance_samples

    @property
    def decodes_per_point(self):
        """``per_ref_feature_output``: JAX decodes each point's reflectance
        feature and returns before the shared decoder."""
        return self.use_reflectance_grid and self.per_ref_feature_output

    @property
    def rotates_illumination(self):
        return bool(self.rotate_illumination and self.config is not None
                    and self.config.rotate_illumination)

    def _rotated_refdirs(self, rays, refdirs):
        """The query directions turned by the ray's illumination rotation."""
        rot = self.light_rotation_matrix[rays.light_idx[..., 0].long()][..., None, :, :]
        return (rot[..., :3, 0] * refdirs[..., 0:1] + rot[..., :3, 1] * refdirs[..., 1:2]
                + rot[..., :3, 2] * refdirs[..., 2:3])

    # --- the distance head ------------------------------------------------------------

    def _ray_warp(self, anchor, lo, hi, uniform_both, uniform_forward=False):
        """(t_to_s, s_to_t) between metric distance and [0, 1] over [lo, hi]:
        the ray warp ``raydist_fn`` (a ``(fn, fn_inv, kwargs)``), affine both
        ways under `uniform_both`, affine forward under `uniform_forward`."""
        warp = warp_inv = None
        if self.raydist_fn is not None:
            fn, fn_inv, fn_kwargs = self.raydist_fn
            warp = functools.partial(fn, **fn_kwargs)
            warp_inv = functools.partial(fn_inv, **fn_kwargs)
        t_to_s, s_to_t = coord.construct_ray_warps(
            warp, torch.ones_like(anchor) * lo, torch.ones_like(anchor) * hi, fn_inv=warp_inv)
        span = hi - lo
        if uniform_both:
            s_to_t = lambda s: s * span + lo  # noqa: E731
            t_to_s = lambda t: (t - lo) / span  # noqa: E731
        elif uniform_forward:
            t_to_s = lambda t: (t - lo) / span  # noqa: E731
        return t_to_s, s_to_t

    def _sample_space_warp(self, anchor):
        """The warps over [distance_near, distance_far]: affine both ways
        under ``use_uniform_distance``, forward under ``use_uniform_loss``."""
        return self._ray_warp(anchor, self.distance_near, self.distance_far,
                              self.use_uniform_distance, self.use_uniform_loss)

    def _tdist_to_s(self, rays, tdist):
        t_to_s, _ = self._sample_space_warp(rays.near)
        return t_to_s(tdist)

    def _s_ladder(self, ndim, device):
        """The samples' base positions in s: uniform over (0, 1), the last
        ``num_far_samples`` packed into [0.9, 1)."""
        k, k_far = self.num_distance_samples, self.num_far_samples
        lin = lambda a, b, n: torch.linspace(a, b, n, device=device)  # noqa: E731
        rungs = (torch.cat([lin(1e-8, 0.9, k - k_far), lin(0.9, 1.0 - 1e-8, k_far)])
                 if k_far > 0 else lin(1e-8, 1.0 - 1e-8, k))
        return rungs.reshape((1,) * ndim + (-1,))

    def _axis_plane_crossings(self, rays, origins, refdirs, shift):
        """Voxel-plane placement: the shifts perturb K / 3 triplets of
        axis-aligned planes spread over [-1, 1] (warped to metric distance
        over [voxel_start, voxel_end], ``use_uniform_grid`` affine), and each
        sample sits where the query ray crosses its plane."""
        _, plane_s_to_t = self._ray_warp(rays.near[..., None, None], self.voxel_start,
                                         self.voxel_end, self.use_uniform_grid)
        k3 = self.num_distance_samples // 3
        planes = shift.reshape(shift.shape[:-1] + (k3, 3))
        stack = torch.linspace(-1.0, 1.0, k3, device=shift.device).reshape(
            (1,) * (planes.dim() - 2) + (k3, 1))
        planes = 2.0 * planes + stack
        planes = plane_s_to_t(torch.abs(planes)) * torch.sign(planes)
        # A direction without a component along an axis crosses none of its
        # planes: its crossings fall far outside the range.
        safe_dirs = torch.where(torch.abs(refdirs) < 1e-5, torch.full_like(refdirs, 1e12),
                                refdirs)
        t = (planes - origins[..., None, :]) / safe_dirs[..., None, :]
        return t.reshape(planes.shape[:-2] + (self.num_distance_samples,))

    def propose_samples(self, rays, origins, refdirs, bottleneck, roughness, near=0.0,
                        far=float("inf")):
        """(points [..., K, 3], blend logits, range mask, s, t [..., K],
        env rgb, env alpha) of the distance head."""
        t_to_s, s_to_t = self._sample_space_warp(rays.near[..., None])
        x = torch.cat([bottleneck, coord.pos_enc(self.warp_fn(origins), 0, self.deg_origins, True),
                       self.dir_enc_fn_distance(refdirs, roughness)], dim=-1)
        raw = self.distance_output_layer(self.distance_layer(x))
        env_rgb = self.rgb_activation(
            self.rgb_premultiplier * raw[..., -_HEAD_TAIL:-1] + self.rgb_bias)
        env_alpha = (self.alpha_activation(raw[..., -1:] + self.alpha_bias) if self.use_env_alpha
                     else torch.ones_like(raw[..., -1:]))
        k = self.num_distance_samples
        block = raw[..., :-_HEAD_TAIL].reshape(raw.shape[:-1] + (k, _HEAD_BLOCK))
        shift = (block[..., 0] * (self.distance_scale / k)
                 * torch.sigmoid(block[..., 1] + self.distance_bias))
        logit, nudge_gate, nudge = block[..., 4], block[..., 2], block[..., 5:8]
        if self.use_voxel_grid:
            t = self._axis_plane_crossings(rays, origins, refdirs, shift)
            s = t_to_s(t)
        else:
            s = _unit_fold(shift + self._s_ladder(shift.dim() - 1, shift.device))
            t = s_to_t(s)
        if self.use_sorted_distances:
            order = torch.argsort(t, dim=-1, stable=True)
            t, s, logit, nudge_gate = (torch.gather(v, -1, order)
                                       for v in (t, s, logit, nudge_gate))
            if self.use_point_offsets:
                # JAX's quirk: each sample's xyz nudge is indexed by the
                # order along its own xyz axis (K <= 3 here,
                # SORTED_NUDGE_GAP).
                nudge = torch.gather(nudge, -1, order[..., None].expand(nudge.shape))
        valid = ((t > self.distance_near) & (t < self.distance_far) & (t > near)
                 & (t < far)).to(torch.float32)
        t = torch.clamp(t, self.distance_near, self.distance_far)
        points = origins[..., None, :] + t[..., None] * refdirs[..., None, :]
        if self.use_point_offsets:
            points = points + (torch.tanh(nudge) * self.point_offset_scale
                               * torch.sigmoid(nudge_gate + self.point_offset_bias)[..., None])
        return points, logit, valid, s, t, env_rgb, env_alpha

    def _alpha_feature_density(self, feature):
        """Each point's density from its reflectance feature."""
        return self.density_activation(
            self.output_density_layer(self.density_layer(feature))[..., 0] + self.density_bias)

    # --- the decoder ------------------------------------------------------------------

    def forward(self, rng, rays, sampler_results, origins, refdirs, roughness=None,
                shader_bottleneck=None, train=True, train_frac=1.0, dist_only=False,
                cache_tdist=None, **kwargs):
        outputs = {}
        origins = origins.reshape(refdirs.shape[:-2] + (-1, 3)) * torch.ones_like(refdirs)
        if cache_tdist is not None:
            outputs["cache_sdist"] = self._tdist_to_s(rays, cache_tdist)
            if dist_only:
                return outputs
        self._check_reference_gaps()
        if self.rotates_illumination:
            refdirs = self._rotated_refdirs(rays, refdirs)
        if self.grid is not None:
            key, rng = torchutil.random_split(rng)
            bottleneck = self.predict_appearance_feature(
                sampler_results, train=train, train_frac=train_frac,
                **self.get_predict_appearance_kwargs(key, rays, sampler_results)
            ) * torch.ones_like(refdirs[..., :1])
        elif self.use_shader_bottleneck:
            bottleneck = shader_bottleneck
        else:
            bottleneck = torch.zeros_like(refdirs)
        feats = []
        if self.use_origins:
            feats.append(coord.pos_enc(origins, 0, self.deg_origins, True))
        if self.use_bottleneck:
            feats.append(bottleneck)
        if self.reads_illumination_feature:
            feats.append(self.get_light_vec(rays, bottleneck))
        if self.use_shader_bottleneck:
            feats.append(shader_bottleneck)

        unit = torch.ones_like(bottleneck[..., 0:1])
        s_distances = distances = env_alpha = torch.zeros_like(unit)
        env_rgb = torch.zeros_like(bottleneck[..., 0:3])
        raw_weights = ref_weights = ref_mask = unit
        points = None
        if self.use_distance_prediction:
            key, rng = torchutil.random_split(rng)
            points, raw_weights, ref_mask, s_distances, distances, env_rgb, env_alpha = (
                self.propose_samples(rays, origins, refdirs, bottleneck, roughness, **kwargs))
            if self.ref_warp_fn is not None:
                points = self.ref_warp_fn(points)
            blend = torch.softmax(raw_weights, dim=-1)
            s_distances = (s_distances * blend).sum(dim=-1, keepdim=True)
            ref_weights = blend * ref_mask * env_alpha
        if self.use_far_field_points:
            points = ref_utils.l2_normalize(refdirs)[..., None, :]
        if self.use_reflectance_grid:
            ref_roughness = (roughness[..., None, :] * distances[..., None] * self.roughness_scale
                             if self.use_roughness else None)
            # per_level_fn=None: every point keeps its own feature (JAX's
            # identity per_level_fn).
            ref_grid_feat = self.reflectance_grid(points, x_scale=ref_roughness,
                                                  per_level_fn=None, train=train,
                                                  train_frac=train_frac)
            if self.use_density_prediction:
                ref_density = self._alpha_feature_density(ref_grid_feat)
                ref_weights, _, _ = render.compute_alpha_weights(
                    ref_density * self.density_activation(raw_weights + self.density_bias), None,
                    refdirs, opaque_background=False,
                    delta=torch.ones_like(distances) / self.num_distance_samples)
                ref_weights = ref_weights * ref_mask
                s_distances = (s_distances * ref_weights).sum(dim=-1, keepdim=True)
            if self.decodes_per_point:
                raw_rgba = self.output_rgba_layer(self.view_dependent_layers(ref_grid_feat))
                per_point_rgb = self.rgb_activation(
                    self.rgb_premultiplier * raw_rgba[..., :3] + self.rgb_bias)
                outputs["incoming_rgb"] = (per_point_rgb * ref_weights[..., None]).sum(dim=-2)
                outputs["incoming_alpha"] = torch.sigmoid(raw_rgba[..., -1:] - 1.0)
                outputs["incoming_env_rgba"] = torch.cat([env_rgb, env_alpha], dim=-1)
                outputs["incoming_weights"] = ref_weights
                outputs["incoming_s_dist"] = s_distances
                outputs["incoming_dist"] = distances
                outputs["incoming_acc"] = ref_weights.sum(dim=-1)
                return outputs
            feats.append((ref_grid_feat * ref_weights[..., None]).sum(dim=-2))
        else:
            s_distances = s_distances.mean(dim=-1, keepdim=True)
        if self.use_points:
            scale = roughness[..., None, :] if self.use_points_ide else train_frac
            feats.append(self.points_enc_fn(ref_utils.l2_normalize(points), scale).reshape(
                origins.shape[:-1] + (-1,)))
        if self.use_sphere_points:
            feats.append(coord.pos_enc(
                ref_utils.l2_normalize(origins + self.sphere_radius * refdirs), 0,
                self.deg_sphere_points, True))
        if self.use_directional_enc:
            feats.append(self.dir_enc_fn(refdirs, roughness))
        x = torch.cat(feats, dim=-1)
        if self.use_lights:
            ambient_x = self.ambient_view_dependent_layers(x)
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
        if self.selects_illumination:
            rgb = self.select_illumination(rays, rgb, bottleneck)
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


def _z_rotation(degrees):
    """[3, 3] rotation about +z by `degrees` (the light rig's turntable), in
    float32 as JAX computes it."""
    a = torch.tensor(degrees / 180 * torch.pi, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros(()), torch.ones(())
    return torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


@gin.configurable
class TransientSurfaceLightFieldMLP(SurfaceLightFieldMLP):
    """The transient cache shader's SLF: time-binned incoming radiance."""

    use_indirect = True
