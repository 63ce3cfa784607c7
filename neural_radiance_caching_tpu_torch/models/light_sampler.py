"""Learnable light samplers and light sources (counterpart of ``LightMLP``
and ``LightSourceMap`` in ``models/light_sampler.py``).

``LightMLP``: a von Mises-Fisher mixture over incoming-light directions at
each surface point, predicted from the sampler's own hash grid; the material
shader uses it to importance-sample secondary rays. Multi-illumination
outputs are not ported yet and raise.

``LightSourceMap``: InvProp's calibrated pulsed light, which the transient
material shader owns: a learnable position offset, look direction, power,
transient shift and dark level, and an angular multiplier (a small network
over the point's angle to the light's look direction, or an angular
Gaussian). Structured light raises.
"""

from __future__ import annotations

import math as pymath

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import shading
from neural_radiance_caching_tpu_torch.models.layers import Configurable, Dense, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math
from neural_radiance_caching_tpu_torch.utils import torchutil


@gin.configurable
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

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        if config.multi_illumination:
            raise NotImplementedError("multi-illumination light samplers are not ported yet")
        feature_dim = self._build_trunk(density_feature_dim)
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


def _quaternion_to_matrix(quaternions):
    """[4] (r, i, j, k) quaternion -> [3, 3] rotation (unnormalised input)."""
    r, i, j, k = quaternions
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack((
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ), -1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def eval_gaussian(quaternion, scale, mean, points):
    """Angular Gaussian light model: exp(-d^T R S S^T R^T d) of the unit
    direction d from each `mean` [N, 3] to its point [N, 3]; returns [N]."""
    rot = _quaternion_to_matrix(quaternion)
    s = torch.diag(scale[:3])
    diff = points - mean
    dist = torch.linalg.norm(diff, dim=-1, keepdim=True)
    diff = diff / (dist + 1e-5)
    exponent = ((rot @ s @ s.T @ rot.T @ diff.T) * diff.T).sum(0)
    return torch.exp(-exponent)


# The angular Gaussian's fitted parameters (the JAX package's defaults).
_DEFAULT_QUATERNION = (51.7835, -49.8733, 6.9429, 5.4460)
_DEFAULT_GAUSSIAN_SCALE = (4.5999e00, 2.5764e-05, -4.2560e00)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@gin.configurable
class LightSourceMap(Configurable, nn.Module):
    """InvProp's learnable pulsed light source.

    Parameters (the JAX module's names): ``light_source_offset``,
    ``transient_shift_offset``, ``dark_level_offset``, ``light_power``,
    ``light_source_direction``, ``quaternion`` and ``scale`` (with
    ``optimize_gaussian``), and the angular multiplier's ``layer_mult_{i}`` /
    ``output_layer_mult`` Dense layers (only where it is a network: the JAX
    module creates them at their first call).
    """

    global_light_source = True
    relative_to_camera = True
    use_gaussian = False
    gaussian_scale = 1.0
    use_light_source_dir = True
    use_light_source_norm = False
    use_network = True
    optimize_light_position = False
    optimize_transient_shift = False
    optimize_dark_level = False
    optimize_gaussian = False
    deg_points = 2
    net_depth = 2
    net_width = 64
    skip_layer = 4
    net_activation = staticmethod(F.relu)
    orthogonal_scale = 0.01
    right_scale = 0.01
    look_scale = 1.0
    light_power_bias = 1.0
    light_power_activation = staticmethod(math.safe_exp)
    light_max_angle = 0.0

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        if config.sl_relight:
            raise NotImplementedError("structured light is not ported yet")
        self.light_source_offset = nn.Parameter(torch.zeros(3))
        self.transient_shift_offset = nn.Parameter(torch.zeros(1))
        self.dark_level_offset = nn.Parameter(torch.zeros(1))
        self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))
        self.light_source_direction = nn.Parameter(torch.zeros(3))
        if self.optimize_gaussian:
            self.quaternion = nn.Parameter(torch.tensor(_DEFAULT_QUATERNION))
            self.scale = nn.Parameter(torch.tensor(_DEFAULT_GAUSSIAN_SCALE))
        if self.use_network and not self.use_gaussian:
            in_dim = (2 if self.use_light_source_dir else 3) * (1 + 2 * self.deg_points)
            widths = [in_dim] + [self.net_width] * self.net_depth
            self.layer_mult = nn.ModuleList(Dense(a, b) for a, b in zip(widths[:-1], widths[1:]))
            # The JAX network tests its skip connection once, after its loop,
            # with the loop's last index (net_depth - 1): so the input joins
            # the output layer's input only when that index is a positive
            # multiple of skip_layer (never at the default depth 2 and skip 4).
            last = self.net_depth - 1
            self._skip_after_loop = last > 0 and last % self.skip_layer == 0
            self.output_layer_mult = Dense(
                self.net_width + (in_dim if self._skip_after_loop else 0), 1)

    # --- calibration getters ---

    def _constant(self, values, like):
        return torch.tensor(values, dtype=like.dtype, device=like.device)

    def get_dark_level(self):
        if self.optimize_dark_level:
            return torch.abs(self.dark_level_offset[0] * self.config.dark_level_multiplier)
        return 0.0

    def get_transient_shift(self):
        if self.optimize_transient_shift:
            return (self.transient_shift_offset[0] * self.config.transient_shift_multiplier
                    + self.config.transient_shift)
        return self.config.transient_shift

    def get_light_source_offset(self):
        if self.optimize_light_position:
            return self.light_source_offset[None] * self.config.light_pos_multiplier
        return torch.zeros_like(self.light_source_offset[None])

    def get_lights(self, lights, look, up):
        sh = lights.shape
        lights = lights.reshape(-1, 3)
        look, up = look.reshape(-1, 3).detach(), up.reshape(-1, 3).detach()
        offset = self.get_light_source_offset()
        if self.global_light_source:
            lights = offset + lights
        else:
            right = _cross(up, look)
            lights = offset[..., 0:1] * right + offset[..., 1:2] * up + offset[..., 2:3] * look \
                + lights
        return lights.reshape(sh)

    def get_lights_opencv(self, lights, look, up, origins):
        right = _cross(up, look)
        return torch.cat([-math.dot(lights - origins, right), -math.dot(lights - origins, up),
                          math.dot(lights - origins, look)], dim=-1)

    def get_light_source_look(self, lights, look, up):
        sh = lights.shape
        look, up = look.reshape(-1, 3).detach(), up.reshape(-1, 3).detach()
        direction = self.light_source_direction[None]
        if self.global_light_source:
            position = self._constant(self.config.light_source_position or (0.0,) * 3, direction)
            ls_look = (direction * self.orthogonal_scale
                       - position[None] * self.look_scale) * torch.ones_like(up)
        else:
            v = torch.cat([direction[..., :2] * self.orthogonal_scale,
                           torch.ones_like(direction[..., :1]) * self.look_scale], dim=-1)
            right = _cross(up, look)
            ls_look = right * v[..., 0:1] + up * v[..., 1:2] + look * v[..., 2:3]
        return ls_look.reshape(sh)

    # --- angular multiplier ---

    def run_network(self, x):
        inputs = x
        for layer in self.layer_mult:
            x = self.net_activation(layer(x))
        if self._skip_after_loop:
            x = torch.cat([x, inputs], dim=-1)
        return x

    def _angular_mult(self, points, lights, look, up):
        """Angular falloff multiplier in (0, 2)."""
        if self.use_light_source_dir:
            ls_look = self.get_light_source_look(lights, look, up)
            ls_right = _cross(up, ls_look)
            p = points / (torch.linalg.norm(points, dim=-1, keepdim=True) + 1e-5)
            net_input = torch.cat([torch.abs(math.dot(p, ls_look)),
                                   torch.abs(math.dot(p, ls_right)) * self.right_scale], dim=-1)
        elif self.use_light_source_norm:
            net_input = points / (torch.linalg.norm(points, dim=-1, keepdim=True) + 1e-5)
        else:
            net_input = points
        if self.use_network:
            x = self.run_network(coord.pos_enc(net_input, 0, self.deg_points, True))
            return torch.sigmoid(self.output_layer_mult(x)) * 2.0
        return torch.ones_like(net_input[..., :1])

    def forward(self, points, viewdirs, lights, look, up, origins, **kwargs):
        """(light radiance, angular multiplier), each [..., 1], at `points`
        [..., 3]; every input is detached."""
        del viewdirs, kwargs
        sh = points.shape
        points, lights, look, up, origins = (
            x.reshape(-1, 3).detach() for x in (points, lights, look, up, origins))
        lights = self.get_lights(lights, look, up)
        if self.use_gaussian:
            right = _cross(up, look)
            local_points = torch.cat([-math.dot(points - origins, right),
                                      -math.dot(points - origins, up),
                                      math.dot(points - origins, look)], dim=-1)
            local_lights = self.get_lights_opencv(lights, look, up, origins)
            quaternion, scale = ((self.quaternion, self.scale) if self.optimize_gaussian else
                                 (self._constant(_DEFAULT_QUATERNION, points),
                                  self._constant(_DEFAULT_GAUSSIAN_SCALE, points)))
            mult = eval_gaussian(quaternion, scale, local_lights, local_points)[..., None] \
                * self.gaussian_scale
        elif self.relative_to_camera:
            mult = self._angular_mult(points - origins, lights, look, up)
        else:
            mult = self._angular_mult(points - lights, lights, look, up)

        mult = mult.reshape(sh[:-1] + (1,))
        light_radiance = mult * self.light_power_activation(self.light_power)
        light_offset = lights - points
        light_dists = torch.linalg.norm(light_offset, dim=-1, keepdim=True)
        if self.config.use_falloff:
            light_radiance = light_radiance / torch.clamp(
                light_dists.reshape(sh[:-1] + (1,)) ** 2, min=1e-5)
        if self.light_max_angle > 0.0:
            light_dirs = light_offset / torch.clamp(light_dists, min=1e-5)
            angle_dot = math.dot(-light_dirs, look, keepdims=True)
            angle = torch.arccos(angle_dot)
            cutoff = (((angle * 180.0 / pymath.pi) > (self.light_max_angle / 2.0))
                      | (angle_dot < 0)).reshape(sh[:-1] + (1,))
            light_radiance = torch.where(cutoff, torch.zeros_like(light_radiance),
                                         light_radiance)
        return light_radiance, mult
