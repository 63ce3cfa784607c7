"""The flagship cache-, material- and transient-cache-stage configurations
(counterpart of ``_cache_config``, ``flagship_cache_params``,
``build_flagship_cache_model``, the material config of ``_main_default``,
``build_flagship_material_model``, the transient config of
``_main_default`` and ``build_flagship_transient_cache_model`` in
``bench.py``).

Cache: two IPE proposal MLPs (4 x 256, bf16), a final 2 x 64 DensityMLP on
an 8-level simplex hash pyramid (16..2048, T = 2^19, F = 4, primary-ray clamp
6, secondary-ray clamp 6), and a 1 x 128 NeRFMLP shader in bf16 with
reflections and its surface light field.

Material: that cache with secondary-ray resampling, a 2 x 64 LightMLP with
128 vMF components on its own 8-level simplex grid, and a MaterialMLP (no
trunk, 128-wide bottleneck, the flagship BRDF head) that traces 32 secondary
rays per surface point (16 GGX+cosine MIS, 16 cosine) through the cache's
64 + 64 + 32 samples; one resampled surface point per ray, batch 1536.

Transient cache (InvProp): the cache with an actively lit TransientNeRFMLP
(point light of learnable constant power, BRDF net, 2 x 64 irradiance net
emitting 700 x 3 time bins, transient SLF), 700 bins of 0.02, the transient
RawNeRF loss, batch 2048. ``scatter_dedup`` turns on the run-dedup of the
density grid's table-gradient scatter.

The eval path's counterparts of ``bench.py:663-771``: ``trained_psnr`` (a
held-out view rendered through ``create_render_fn`` and ``render_image``),
``trained_psnr_gate`` (200 real-lr steps, then that PSNR, against
``TRAINED_PSNR_FLOOR``) and ``bench_eval_render`` (the eval-render timing).
Unlike the JAX bench, a gate that raises is not recorded and passed over:
the error reaches the caller, as does a reading below the floor.

The builders return the model on the card unless given ``device="cpu"``,
and raise without one. Parameters are initialised on the CPU from torch's
default generator, so one seed gives the same weights on every device, and
then moved.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.data import datasets
from neural_radiance_caching_tpu_torch.engine import renderer
from neural_radiance_caching_tpu_torch.engine.configs import Config
from neural_radiance_caching_tpu_torch.models.layers import softplus
from neural_radiance_caching_tpu_torch.models.material_model import MaterialModel
from neural_radiance_caching_tpu_torch.models.nerf_model import NeRFModel, TransientNeRFModel
from neural_radiance_caching_tpu_torch.ops import coord
from neural_radiance_caching_tpu_torch.parallel import train as train_lib
from neural_radiance_caching_tpu_torch.utils import torchutil

BATCH_SIZE = 8192
MATERIAL_BATCH_SIZE = 1536
TRANSIENT_BATCH_SIZE = 2048
TRANSIENT_N_BINS = 700
PROPOSAL_WIDTH = 256
PRIMARY_LEVEL_CLAMP = 6
SECONDARY_LEVEL_CLAMP = 6
# The held-out PSNR a 200-step gate run must reach (bench.py:92).
TRAINED_PSNR_FLOOR = 20.0


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


def _build(model_cls, config, params, device):
    torchutil.check_device(device, "a model", "build it on the CPU")
    return model_cls(config=config, **params).to(device)


def build_flagship_cache_model(config, params=None, device="cuda"):
    return _build(NeRFModel, config, params or flagship_cache_params(), device)


def material_config(**overrides):
    """The flagship material-stage Config: the cache Config with the material
    stage's overrides."""
    fields = dict(
        batch_size=MATERIAL_BATCH_SIZE, secondary_far=4.0, material_loss_radius=4.0,
        data_loss_type="rawnerf_unbiased", use_gradient_debias=True,
        gradient_checkpointing=True, distortion_loss_mult=0.0,
        predicted_normal_loss_mult=0.0, predicted_normal_reverse_loss_mult=0.0,
    )
    fields.update(overrides)
    return cache_config(**fields)


# The flagship BRDF head: sigmoid roughness at bias -1 (GGX alpha in (0, 1)),
# roughness gradient damped to 0.25, min roughness 0.01.
FLAGSHIP_BRDF_HEAD = {
    "brdf_bias": {
        "albedo": -1.0, "specular_albedo": -1.0, "roughness": -1.0,
        "F_0": -3.078, "metalness": 0.0, "diffuseness": 0.0,
        "mirrorness": 2.0, "specular_multiplier": 0.0,
        "diffuse_multiplier": 0.0,
    },
    "brdf_activation": {"roughness": torch.sigmoid},
    "brdf_stopgrad": {"roughness": 0.25},
    "min_roughness": 0.01,
}


def flagship_material_params(cache_params=None):
    """MaterialModel keyword arguments of the flagship material model."""
    cache_params = dict(cache_params or flagship_cache_params())
    cache_params["resample_secondary"] = True
    strategy = cache_params["train_sampling_strategy"]
    grid = {
        "hash_map_size": 524288, "max_grid_size": 2048, "num_features": 4,
        "scale_supersample": 1.0, "interpolation": "simplex", "bbox_scaling": 2.0,
    }
    return dict(
        cache_model_params=cache_params,
        use_light_sampler=True,
        light_sampler_params={
            "net_depth": 2, "net_width": 64, "bottleneck_width": 128,
            "num_components": 128, "vmf_scale": 20.0,
            "use_density_feature": False, "use_grid": True,
            "grid_params": grid, "warp_fn": coord.contract_radius_2,
        },
        shader_params={
            "net_depth": 0, "net_width": 64, "bottleneck_width": 128,
            "use_density_feature": False, "use_grid": True,
            "grid_params": grid, "warp_fn": coord.contract_radius_2,
            "num_secondary_samples": 32, "render_num_secondary_samples": 32,
            "num_secondary_samples_diff": 4, "render_num_secondary_samples_diff": 4,
            "cache_train_sampling_strategy": strategy,
            "cache_render_sampling_strategy": strategy,
            "net_depth_brdf": 2, "net_width_brdf": 64,
            "use_brdf_correction": False,
            **FLAGSHIP_BRDF_HEAD,
        },
        resample=True,
        resample_render=True,
        num_resample=1,
        slf_variate=False,
    )


def build_flagship_material_model(config, params=None, device="cuda"):
    return _build(MaterialModel, config, params or flagship_material_params(), device)


def transient_config(**overrides):
    """The flagship transient cache-stage Config: the cache Config with the
    transient stage's overrides. The bins of 0.02 cover the scene's
    two-bounce path lengths (near 2, far 6: up to 14 units)."""
    fields = dict(
        batch_size=TRANSIENT_BATCH_SIZE, use_transient=True, n_bins=TRANSIENT_N_BINS,
        exposure_time=0.02, learnable_light=True, light_source_position=[0.0, 0.0, 1.0],
        data_loss_type="rawnerf_transient_unbiased", linear_to_srgb=False,
    )
    fields.update(overrides)
    return cache_config(**fields)


def flagship_transient_cache_params(scatter_dedup=False):
    """TransientNeRFModel keyword arguments: the flagship cache with the
    active shader (use_active, use_indirect, no ambient, 2 x 64 irradiance
    net) and no secondary-ray resampling; `scatter_dedup` sets the density
    grid's run-dedup of the table-gradient scatter."""
    params = flagship_cache_params()
    shader = dict(params["shader_params"])
    shader.update(use_active=True, use_indirect=True, use_ambient=False,
                  net_depth_irradiance=2, net_width_irradiance=64)
    params["shader_params"] = shader
    params["resample_secondary"] = False
    if scatter_dedup:
        sp = params["sampler_params"]
        grids = list(sp["grid_params_per_level"])
        grids[-1] = dict(grids[-1], scatter_dedup=True)
        sp["grid_params_per_level"] = tuple(grids)
    return params


def build_flagship_transient_cache_model(config, params=None, device="cuda"):
    return _build(TransientNeRFModel, config, params or flagship_transient_cache_params(), device)


# --- eval -----------------------------------------------------------------------


def _psnr_db(rgb, gt):
    mse = float(np.mean((np.clip(rgb, 0, 1) - gt) ** 2))
    return round(-10 * np.log10(mse + 1e-12), 2)


def trained_psnr(model, config, resolution=64, device="cuda"):
    """PSNR of view 0 of a held-out SyntheticSpheres test set (2 views at
    `resolution`^2), rendered by `model` as it stands; both images clipped to
    [0, 1], rounded to 2 places."""
    ds = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=resolution,
                                   device=device)
    batch = ds.generate_ray_batch(0)
    out = renderer.render_image(
        train_lib.create_render_fn(model), batch.rays,
        torch.Generator(device=device).manual_seed(7), config, height=ds.height,
        width=ds.width, train_frac=1.0, device=device)
    gt = np.clip(batch.rgb.cpu().numpy().reshape(out["rgb"].shape), 0, 1)
    return _psnr_db(out["rgb"], gt)


def trained_psnr_gate(model, config, dataset, steps=200, resolution=64):
    """Train `model` for `steps` steps at a real learning rate on `dataset`,
    then return ``trained_psnr``: the quality check the throughput numbers
    cannot give (an integrator or encoder fault that keeps the step time and
    the loss shape).

    `model` is trained in place, so pass a freshly built flagship cache
    model: the JAX gate re-initialises the benched model's variables, and a
    torch module holds its own. The schedule is lr 0.01 -> 0.003 with a
    50-step delay over `steps`; 16 batches drawn ahead are used in turn.
    Comparable run to run only at a fixed `steps`.
    """
    gate_config = dataclasses.replace(config, lr_init=0.01, lr_final=0.003, lr_delay_steps=50,
                                      max_steps=steps)
    state, _ = train_lib.create_optimizer(gate_config, model)
    train_step = train_lib.create_train_step(model, gate_config)
    batches = [dataset.next_train() for _ in range(16)]
    rng = torch.Generator(device=dataset.device).manual_seed(5)
    for i in range(steps):
        state, stats = train_step(rng, state, batches[i % len(batches)], i / max(1, steps - 1))
    float(stats["loss"])  # wait for the last step
    return trained_psnr(model, gate_config, resolution=resolution, device=dataset.device)


def bench_eval_render(model, config, dataset, n_images=3):
    """Time whole-image eval renders of view 0 of `dataset` through
    ``render_image``, host fetches included: one warmup image, then
    `n_images` timed ones with every extra, then the same with the rgb-only
    render function (``compute_extras=False``, ``keys=("rgb",)``).

    Returns (mean s/image, detail); detail also holds each image's time and
    the untrained PSNR, a sanity anchor that the render made an image, not
    a quality number.
    """
    batch = dataset.generate_ray_batch(0)
    num_rays = batch.rays.origins.shape[0]
    rng = torch.Generator(device=dataset.device).manual_seed(11)
    kwargs = dict(config=config, height=dataset.height, width=dataset.width,
                  device=dataset.device)

    def timed(render_fn, **kw):
        renderer.render_image(render_fn, batch.rays, rng, **kwargs, **kw)
        times, out = [], None
        for _ in range(n_images):
            t0 = time.perf_counter()
            out = renderer.render_image(render_fn, batch.rays, rng, **kwargs, **kw)
            times.append(time.perf_counter() - t0)
        return times, out

    times, out = timed(train_lib.create_render_fn(model))
    fast_times, _ = timed(train_lib.create_render_fn(model, compute_extras=False), keys=("rgb",))
    dt, dt_fast = float(np.mean(times)), float(np.mean(fast_times))
    gt = batch.rgb.cpu().numpy().reshape(out["rgb"].shape)
    return dt, {
        "rays_per_image": int(num_rays),
        "sec_per_image": dt,
        "ms_per_ray": dt * 1e3 / num_rays,
        "rays_per_sec": num_rays / dt,
        "render_chunk_size": config.render_chunk_size,
        "image_secs": times,
        "rgb_only_sec_per_image": dt_fast,
        "rgb_only_rays_per_sec": num_rays / dt_fast,
        "rgb_only_image_secs": fast_times,
        "untrained_psnr": _psnr_db(out["rgb"], gt),
    }
