"""The flagship cache-stage configuration (counterpart of ``_cache_config``,
``flagship_cache_params`` and ``build_flagship_cache_model`` in ``bench.py``).

Two IPE proposal MLPs (4 x 256, bf16), a final 2 x 64 DensityMLP on an
8-level simplex hash pyramid (16..2048, T = 2^19, F = 4, primary-ray clamp
6), and a 1 x 128 NeRFMLP shader in bf16 with reflections and its surface
light field.
"""

from __future__ import annotations

from neural_radiance_caching_tpu_torch.engine.configs import Config
from neural_radiance_caching_tpu_torch.models.layers import softplus
from neural_radiance_caching_tpu_torch.models.nerf_model import NeRFModel
from neural_radiance_caching_tpu_torch.ops import coord

BATCH_SIZE = 8192
PROPOSAL_WIDTH = 256
PRIMARY_LEVEL_CLAMP = 6
SECONDARY_LEVEL_CLAMP = 6


def cache_config(**overrides):
    """The flagship cache-stage Config."""
    fields = dict(
        batch_size=BATCH_SIZE, gradient_checkpointing=False,
        near=2.0, far=6.0, max_steps=25000, lr_init=0.01, lr_final=0.001, lr_delay_steps=2500,
        lr_delay_mult=1e-8, adam_eps=1e-15, data_loss_type="charb",
        interlevel_loss_mults=(0.01, 0.01), interlevel_loss_blurs=(0.03, 0.003),
        distortion_loss_mult=0.01, predicted_normal_loss_mult=0.05,
        predicted_normal_reverse_loss_mult=0.05, mask_lossmult=False, linear_to_srgb=True,
    )
    fields.update(overrides)
    return Config(**fields)


def flagship_cache_params():
    """NeRFModel keyword arguments of the flagship cache model."""
    appearance_grid = {
        "hash_map_size": 524288, "max_grid_size": 2048, "num_features": 4,
        "scale_supersample": 1.0, "interpolation": "simplex", "bbox_scaling": 2.0,
    }
    proposal_mlp = {
        "net_depth": 4, "net_width": PROPOSAL_WIDTH, "use_grid": False,
        "min_deg_point": 0, "max_deg_point": 8,
        "disable_density_normals": True, "enable_pred_normals": False,
        "normals_for_filter_only": True, "warp_fn": coord.contract_radius_2,
        "use_bf16_compute": True,
    }
    mlp = {
        "net_depth": 2, "net_width": 64, "disable_density_normals": True,
        "enable_pred_normals": True, "warp_fn": coord.contract_radius_2,
        "secondary_grid_level_clamp": SECONDARY_LEVEL_CLAMP,
        "primary_grid_level_clamp": PRIMARY_LEVEL_CLAMP,
    }
    slf = {
        "net_depth": 2, "net_width": 64, "skip_layer": 2, "bottleneck_width": 128,
        "use_directional_enc": True, "use_ide": True, "deg_view": 5,
        "net_depth_viewdirs": 4, "net_width_viewdirs": 128, "bottleneck_viewdirs": 128,
        "skip_layer_dir": 2, "use_grid": False, "use_bottleneck": False,
        "use_density_feature": False, "use_shader_bottleneck": True, "use_lights": False,
    }
    strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    return dict(
        sampler_params={
            "sampling_strategy": strategy,
            "mlp_params_per_level": (proposal_mlp, proposal_mlp, mlp),
            "grid_params_per_level": (None, None, appearance_grid),
            "dilation_bias": 0.0, "dilation_multiplier": 0.0,
            "anneal_clip": 0.4, "resample_padding": 1e-5,
            "raydist_fn": None,
        },
        shader_params={
            "net_depth": 1, "net_width": 128, "bottleneck_width": 128,
            "use_grid": False, "use_density_feature": True,
            "warp_fn": coord.contract_radius_2,
            "use_reflections": True, "enable_pred_roughness": True,
            "use_specular_tint": True,
            "use_ambient": True, "use_indirect": False, "use_active": False,
            "surface_lf_params": slf,
            "net_depth_integrated_brdf": 2, "net_width_integrated_brdf": 64,
            "skip_layer_integrated_brdf": 2,
            "net_depth_brdf": 2, "net_width_brdf": 64, "skip_layer_brdf": 2,
            "net_depth_irradiance": 2, "net_width_irradiance": 64,
            "skip_layer_irradiance": 2,
            "rgb_activation": softplus,
            "use_bf16_compute": True,
        },
        train_sampling_strategy=strategy,
        render_sampling_strategy=strategy,
    )


def build_flagship_cache_model(config, params=None):
    return NeRFModel(config=config, **(params or flagship_cache_params()))
