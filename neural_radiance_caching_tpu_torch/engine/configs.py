"""The gin-configurable ``Config`` dataclass, the framework's flag surface
(counterpart of ``engine/configs.py``).

Every field of the JAX ``Config``, with the same name and default, so the
``configs/*.gin`` files bind unchanged. A Config never raises when it is
built (the ``Trainer`` builds one for every stage): a field whose code path
is not ported raises where it is read.

One field is the port's own: ``transient_shift_form`` picks how the
transient integrator shifts and sums the per-sample indirect transients
(``"gather"``, ``"fft"`` or ``"matmul"``, see ``ops/render.py``), per call
from the Config. It takes the place of the JAX package's process-global
``set_fft_transient_shift`` / ``set_spectral_backend``.

The functions that the gin files name with ``@`` (``math.*``, ``coord.*``,
``jax.nn.*``, ``jnp.*``) are registered under those names and resolve to
the port's counterparts: ``@jax.nn.gelu`` is the tanh approximation and
``@jax.nn.softplus`` is ``layers.softplus``, as in JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models.layers import softplus
from neural_radiance_caching_tpu_torch.ops import coord, math


@gin.constants_from_enum
class ModelType(enum.Enum):
    DEFAULT = "default"
    MATERIAL = "material"
    TRANSIENT_MATERIAL = "transient_material"


# The functions the gin files reference with @-syntax, by gin name.
GIN_FUNCTIONS = {
    "math.abs": math.abs_,
    "math.safe_exp": math.safe_exp,
    "math.safe_tanh": math.safe_tanh,
    "math.power_3": math.power_3,
    "math.laplace_cdf": math.laplace_cdf,
    "math.scaled_softplus": math.scaled_softplus,
    "math.power_ladder": math.power_ladder,
    "math.inv_power_ladder": math.inv_power_ladder,
    "math.safe_log": math.safe_log,
    "math.safe_sqrt": math.safe_sqrt,
    "math.sine_plus": math.sine_plus,
    "math.create_learning_rate_decay": math.create_learning_rate_decay,
    **{f"coord.{name}": getattr(coord, name) for name in (
        "contract", "contract_constant", "contract_constant_1", "contract_radius_5",
        "contract_radius_2", "contract_radius_1_2", "contract_radius_1_4", "contract_cube",
        "contract_cube_5", "contract_cube_2", "contract_cube_1_2", "contract_cube_1_4",
        "contract_projective")},
    "jax.nn.relu": F.relu,
    "jax.nn.sigmoid": torch.sigmoid,
    "jax.nn.softplus": softplus,
    "jax.nn.silu": F.silu,
    "jax.nn.gelu": functools.partial(F.gelu, approximate="tanh"),
    "jax.nn.tanh": torch.tanh,
    "jax.nn.elu": F.elu,
    "jnp.mean": torch.mean,
    "jnp.sum": torch.sum,
    "jnp.abs": torch.abs,
    "jnp.exp": torch.exp,
    "jnp.log": torch.log,
}
for _name, _fn in GIN_FUNCTIONS.items():
    _module, _short = _name.rsplit(".", 1)
    gin.external_configurable(_fn, module=_module, name=_short)


def gin_name(fn):
    """The gin name a registered function was registered under, else None."""
    return next((k for k, v in GIN_FUNCTIONS.items() if v is fn), None)


@gin.configurable
@dataclasses.dataclass
class Config:
    """Framework configuration; every field is gin-bindable as Config.<name>."""

    # --- Dataset ---
    dataset_loader: str = "llff"
    data_dir: Optional[str] = None
    batching: str = "all_images"
    batch_size: int = 16384
    base_batch_size: int = 65536
    patch_size: int = 1
    factor: int = 0
    num_dataset_images: int = -1
    # SyntheticSpheres procedural scene shading: "legacy" (flat ambient +
    # unattenuated lambert) or "physical" (inverse-square point light +
    # sphere shadows + constant-environment ambient — the rendering
    # equation the material model implements, so inverse rendering on the
    # procedural scene is well-posed).
    synthetic_spheres_shading: str = "legacy"
    # Per-image light positions for the procedural scene (physical shading
    # only): each view is lit from a different azimuth around the scene, the
    # light-stage setup (reference OpenIllumination, datasets.py:3271-3410)
    # that disentangles albedo from shading — a shading residual baked into
    # albedo is inconsistent across illuminants, while a single fixed light
    # leaves the split under-constrained up to any spatial factor that
    # matches the one illumination field.
    synthetic_spheres_multi_illum: bool = False
    # Sensor impulse response width (in bins) for the procedural transient
    # GT: >0 convolves the analytically-binned transients with a Gaussian
    # pulse AND hands the same kernel to the model via rays.impulse_response
    # — reproducing the captured pipeline's wide-pulse metric conditions
    # (reference trainer.py:1626-1647 scores IoU between signals that both
    # carry the sensor IR).
    synthetic_spheres_impulse_sigma: float = 0.0
    multiscale: bool = False
    multiscale_levels: int = 4
    forward_facing: bool = False
    render_path: bool = False
    llffhold: int = 8
    world_scale: float = 1.0  # camera positions divided by this (Aerial)
    dtu_light_cond: int = 2
    render_path_frames: int = 120
    z_variation: float = 0.0
    z_phase: float = 0.0
    llff_use_all_images_for_training: bool = False
    use_tiffs: bool = False
    use_exrs: bool = False
    load_disps: bool = False
    load_normals: bool = False
    load_albedos: bool = False
    # Image dims for loaders whose JSON poses don't carry them (transient h5).
    height: int = 512
    width: int = 512
    test_height: int = 128
    test_width: int = 128
    test_start_bin: int = 0
    rgb_max: float = float("inf")
    mask_threshold: float = 0.0
    light_transforms: Optional[List[Any]] = None
    sl_paths: Optional[List[str]] = None
    viz_index: int = 0
    viz_name: Optional[str] = None
    impulse_response: Optional[str] = None
    impulse_response_start_bin: int = 0
    n_impulse_response_bins: int = 0
    light_static_wrt_camera: bool = False
    image_subdir: Optional[str] = None
    llff_load_from_poses_bounds: bool = False
    load_ngp_format_poses: bool = False
    load_alphabetical: bool = True
    exposure_percentile: float = 97.0
    compute_disp_metrics: bool = False
    compute_normal_metrics: bool = False
    compute_albedo_metrics: bool = False
    compute_depth_metrics: bool = True
    compute_transient_metrics: bool = False
    correct_eval: bool = False  # Procrustes camera alignment before eval.
    # Shift-invariant eval metrics (ops/image.py): search-window for the best
    # integer-pixel shift (reference configs.py:667-670).
    use_shift_invariance: bool = False
    shift_invariant_start: int = -4
    shift_invariant_end: int = 4
    shift_invariant_step: int = 1
    # Transient vis: bin range scrubbed over the eval sequence
    # (reference trainer.py:1704).
    transient_start_idx: int = 0
    transient_end_idx: int = 1000
    var_scale: float = 1.0  # Scale on visualized rgb variance (vis.py:328).
    secondary_rays_no_vis_transform: bool = False  # Probe camera orientation.
    # Fields that the published configs bind but no code reads (in the JAX
    # package either); accepted so those configs parse.
    rawnerf_min: float = 1e-4
    rawnerf_min_material: float = 1e-4
    use_combined_rawnerf_material: bool = True
    use_surfaces: bool = False
    light_name: Optional[str] = None
    use_geometry_weight_decay: bool = False
    geometry_weight_decay_frac: float = 0.0
    geometry_weight_decay_start: float = 0.0
    geometry_weight_decay_min: float = 0.0
    use_masks: bool = False
    near: float = 2.0
    far: float = 6.0
    secondary_far: float = 2.0
    light_near: float = 0.0

    # Scene transforms
    rescale_scene: float = 1.0
    meshfile: str = ""
    use_mesh_face_normals: bool = False

    # --- Model selection ---
    model_type: ModelType = ModelType.MATERIAL
    use_transient: bool = False
    num_rgb_channels: int = 3
    linear_to_srgb: bool = False
    light_sampling_linear_to_srgb: bool = True
    surface_light_field_linear_to_srgb: bool = True

    # Multi-illumination
    multi_illumination: bool = False
    num_illuminations: int = 1
    multiple_illumination_outputs: bool = True
    rotate_illumination: bool = False
    light_rotations: Optional[List[float]] = None
    use_ground_truth_illumination: bool = False

    # --- Transient / iToF ---
    n_bins: int = 700
    exposure_time: float = 0.01
    transient_shift: float = 0.0
    dark_level: float = 0.0
    learnable_light: bool = False
    tfilter_sigma: float = 0.0
    filter_indirect: bool = False
    filter_median: bool = False
    filter_median_thresh: float = 0.0
    no_shift_direct: bool = False
    use_itof: bool = False
    itof_frequency_phase_shifts: List[Any] = dataclasses.field(default_factory=list)
    transient_gauss_sigma_scales: List[Any] = dataclasses.field(default_factory=list)
    impulse_response: Optional[Any] = None
    test_impulse_response: Optional[Any] = None
    start_bin: int = 0
    dataset_scale: float = 1.0
    light_source_position: Optional[List[float]] = None
    dark_level_multiplier: float = 1.0
    transient_shift_multiplier: float = 1.0
    light_pos_multiplier: float = 1.0
    # The port's own field: how the transient integrator shifts and sums the
    # per-sample indirect transients ("gather", "fft" or "matmul", see
    # ops/render.py), per call.
    transient_shift_form: str = "fft"
    vis_only: bool = False
    no_vis: bool = False
    test_factor: Optional[int] = None
    y_up: bool = False
    img_scale: float = 1.0
    flip_secondary: bool = False
    eval_train: bool = False
    eval_path: bool = False
    vis_render_path: bool = False
    fixed_light: bool = False
    fixed_camera: bool = False
    light_transform_idx: int = 0
    round_roughness: bool = False

    # --- Active lighting ---
    use_falloff: bool = True
    light_zero: bool = True
    light_intensity_conditioning: bool = False
    light_intensity_conditioning_scale: float = 1.0
    light_intensity_conditioning_bias: float = 0.0
    # Condition the indirect nets on azimuth-invariant light features in the
    # local surface frame (n-dot-l, view/light tangential geometry, log
    # distance) instead of the raw world light position. Turns novel-light-
    # azimuth relighting into interpolation (parity-plus; the reference
    # trains one run per fixed illumination, datasets.py:3271-3410).
    light_canonical_frame: bool = False
    sl_relight: bool = False
    sl_hfov: float = 10.0
    sl_vfov: float = 10.0
    sl_shift: Tuple[float, float] = (0.0, 0.0)
    sl_mult: float = 5.0
    sl_invert: bool = False
    bin_zero_threshold_light: float = 2.0

    # --- Secondary rays / material ---
    secondary_normal_eps: float = 1e-2
    shadow_normal_eps_dot_min: float = 1e-2
    shadow_near_start_frac: float = 0.0
    occ_threshold_rate: float = 0.0
    occ_threshold_start_frac: float = 0.0
    occ_threshold_min: float = 0.0
    occ_threshold_max: float = 0.0
    shadow_normal_eps_rate: float = 0.0
    shadow_near_min: float = 1e-1
    shadow_near_max: float = 1e-1
    shadow_near_rate: float = 0.1
    shadow_sampling_strategy: Tuple[Tuple[int, int, int], ...] = (
        (0, 0, 64),
        (1, 1, 64),
        (2, 2, 32),
    )
    shadow_normals_target: str = "normals_to_use"
    material_normals_target: str = "normals_to_use"
    env_map_distance: float = float("inf")
    compute_relight_metrics: bool = False
    filter_normals_thresh: float = float("inf")
    env_map_name: str = "sunset"
    partial_checkpoint_dir: str = ""
    use_occlusions: bool = False
    occlusions_secondary_only: bool = True
    occlusions_primary_only: bool = True
    volume_variate: bool = False
    volume_variate_material: bool = False
    volume_variate_secondary: bool = False
    volume_variate_passes: List[str] = dataclasses.field(default_factory=list)
    volume_variate_passes_secondary: List[str] = dataclasses.field(
        default_factory=lambda: ["diffuse"]
    )

    # --- Optimization ---
    max_steps: int = 25000
    early_exit_steps: Optional[int] = None
    lr_init: float = 0.01
    lr_final: float = 0.001
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 1e-8
    lr_factor: float = 1.0
    lr_factor_mult: float = 1.0
    train_length_mult: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_eps: float = 1e-15
    grad_max_norm: float = 0.0
    grad_max_val: float = 0.0
    use_grad_accum: bool = False
    grad_accum_steps: int = 1
    use_secondary_grad_accum: bool = False
    secondary_grad_accum_steps: int = 1
    extra_opt_params: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    finetune_multiplier: float = 10.0
    train_exclude_prefixes: List[str] = dataclasses.field(default_factory=list)
    use_gradient_debias: bool = False
    loss_scale: float = 1.0
    enable_loss_scaler: bool = False
    checkpoint_every: int = 5000
    print_every: int = 100
    visualize_every: int = 5000
    train_render_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 2
    gc_every: int = 10000
    # When set, capture a profiler trace of steps
    # [profile_start_step, profile_start_step + profile_num_steps) into this
    # directory.
    profile_dir: Optional[str] = None
    profile_start_step: int = 20
    profile_num_steps: int = 5
    # The JAX package's eager-loop switch; the port's loop is always eager.
    disable_pmap_and_jit: bool = False
    # Per-step debug instrumentation: per-module weight/grad norms and maxes
    # in stats, non-finite / all-zero gradient warnings, ray-distance
    # percentile histograms.
    debug_mode: bool = False
    cast_rays_in_train_step: bool = False
    cast_rays_in_eval_step: bool = False
    randomized: bool = True
    jitter_rays: int = 0
    disable_multiscale_loss: bool = False
    donate_args_to_train: bool = True
    gradient_checkpointing: bool = False

    # --- Data losses ---
    data_loss_type: str = "charb"
    data_loss_mult: float = 1.0
    data_coarse_loss_mult: float = 0.0
    data_loss_gauss_mult: float = 1.0
    transient_gauss_constant_scale: float = 1.0
    charb_padding: float = 0.001
    # Patch-wise bilateral depth smoothness (reference configs.py:901-904,
    # loss_utils.py:204-237). Requires patch_size > 1 so batches carry patches.
    patch_loss_mult: float = 0.0
    bilateral_strength: float = 0.0
    patch_variance_weighting: float = 0.0
    num_border_pixels_to_mask: int = 0
    rawnerf_exponent: int = 1
    rawnerf_exponent_material: int = 1
    rawnerf_eps: float = 1e-2
    rawnerf_eps_material: float = 1e-2
    rawnerf_mode: bool = False
    use_gt_rawnerf: bool = False
    use_combined_rawnerf: bool = False
    use_norm_rawnerf: bool = False
    convert_srgb: bool = False
    is_material: bool = False
    use_loss_clip: bool = False
    loss_clip_min: float = 0.0
    loss_thresh: float = float("inf")
    loss_clip: float = float("inf")
    loss_clip_max: float = float("inf")
    use_mask_weight_ease: bool = False
    mask_weight_ease_start: float = 0.0
    mask_weight_ease_frac: float = 0.0
    mask_weight_ease_min: float = 0.0
    use_mask_weight_decay: bool = False
    mask_weight_decay_start: float = 0.0
    mask_weight_decay_frac: float = 0.0
    mask_weight_decay_min: float = 0.0
    normalize_distortion_loss: bool = False
    orientation_loss_normalize: bool = False
    orientation_loss_stopgrad: bool = False
    predicted_normal_loss_normalize: bool = False
    predicted_normal_weight_loss_mult: float = 0.0
    mask_lossmult: bool = True
    mask_lossmult_weight: float = 0.0
    evaluate_without_masks: bool = False
    clip_eval: bool = False
    opaque_loss_weight: float = 0.0
    empty_loss_weight: float = 0.0
    backward_mask_loss: bool = False
    backward_mask_loss_weight: float = 0.0
    disable_outside_loss: bool = False

    # --- Geometry / sampler losses ---
    use_spline_interlevel_loss: bool = True
    interlevel_loss_mults: Tuple[float, ...] = (0.01, 0.01)
    interlevel_loss_blurs: Tuple[float, ...] = (0.03, 0.003)
    material_interlevel_loss_mults: Tuple[float, ...] = (0.0, 0.0)
    distortion_loss_mult: float = 0.0
    distortion_loss_target: str = "tdist"
    distortion_loss_curve_fn: Optional[Tuple[Callable, Dict[str, Any]]] = None
    orientation_loss_mult: float = 0.0
    orientation_loss_target: str = "normals_pred"
    orientation_coarse_loss_mult: float = 0.0
    predicted_normal_loss_mult: float = 0.0
    predicted_normal_reverse_loss_mult: float = 0.0
    predicted_normal_coarse_loss_mult: float = 0.0
    material_predicted_normal_loss_mult: float = 1.0
    predicted_normal_loss_stopgrad: bool = False
    predicted_normal_loss_stopgrad_weight: float = 1.0
    use_normal_weight_ease: bool = False
    use_normal_weight_ease_backward: bool = False
    normal_weight_ease_frac: float = 0.0
    normal_weight_ease_start: float = 0.0
    normal_weight_ease_min: float = 0.0
    # Normal-loss weight DECAY (reference configs.py:389-393): a late-training
    # ramp-down multiplying the orientation/predicted-normal losses.
    use_normal_weight_decay: bool = False
    use_normal_weight_decay_backward: bool = False
    normal_weight_decay_start: float = 0.0
    normal_weight_decay_frac: float = 0.1
    normal_weight_decay_min: float = 0.01
    eikonal_loss_mult: float = 0.0
    eikonal_coarse_loss_mult: float = 0.0
    param_regularizers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_geometry_smoothness: bool = False
    geometry_smoothness_noise: float = 0.01
    geometry_smoothness_weight_normals: float = 0.0
    geometry_smoothness_weight_normals_pred: float = 0.0
    geometry_smoothness_weight_density: float = 0.0

    # --- Material-stage losses (wired in the material phase) ---
    no_material_regularizers: bool = False
    cache_consistency_loss_type: str = "charb"
    cache_consistency_loss_mode: str = "shader"
    cache_consistency_use_integrated: bool = True
    cache_consistency_loss_weight: float = 0.0
    cache_consistency_stopgrad_weight_cache: float = 1.0
    cache_consistency_stopgrad_weight_material: float = 0.0
    cache_consistency_fix_shader: bool = False
    cache_consistency_direct_weight: float = 1.0
    cache_consistency_indirect_weight: float = 1.0
    cache_consistency_use_total: bool = False
    cache_consistency_use_gauss: bool = True
    emission_zero_loss_mult: float = 0.0
    emission_constant_loss_mult: float = 0.0
    material_smoothness_noise: float = 0.01
    material_smoothness_weight_albedo: float = 0.0
    material_smoothness_weight_other: float = 0.0
    material_smoothness_l1_loss: bool = True
    material_smoothness_albedo_stopgrad: bool = False
    material_smoothness_tensoir_albedo: bool = False
    material_smoothness_base: float = 0.1
    material_smoothness_irradiance_multiplier: float = 4.0
    material_smoothness_irradiance_weight: bool = False
    material_correlation_weight_albedo: float = 0.0
    material_correlation_weight_other: float = 0.0
    material_ray_sampler_interlevel_loss_mult: float = 0.0
    material_ray_sampler_normal_loss_mult: float = 0.0
    material_ray_sampler_distortion_loss_mult: float = 1.0
    material_ray_sampler_orientation_loss_mult: float = 1.0
    extra_ray_regularizer: bool = False
    extra_ray_type: str = "incoming"
    extra_ray_light_shuffle: bool = True
    extra_ray_loss_mult: float = 0.0
    extra_ray_loss_stopgrad_weight_gt: float = 1.0
    extra_ray_loss_stopgrad_weight_pred: float = 1.0
    use_extra_ray_weight_ease: bool = False
    extra_ray_weight_ease_frac: float = 0.0
    extra_ray_weight_ease_start: float = 0.0
    extra_ray_weight_ease_min: float = 0.0
    use_consistency_weight_ease: bool = False
    consistency_weight_ease_frac: float = 0.0
    consistency_weight_ease_start: float = 0.0
    consistency_weight_ease_min: float = 0.0
    use_material_weight_ease: bool = False
    material_weight_ease_frac: float = 0.0
    material_weight_ease_start: float = 0.0
    material_weight_ease_min: float = 0.0
    use_surface_light_field_weight_ease: bool = False
    surface_light_field_weight_ease_frac: float = 0.0
    surface_light_field_weight_ease_start: float = 0.0
    surface_light_field_weight_ease_min: float = 0.0
    surface_light_field_is_secondary: bool = False
    # extra_losses: {loss_name: {output_key: {"mult": float, "start_frac": float}}}
    # synthesized per-stage by the Trainer (engine/trainer.py, reference
    # engine/trainer.py:305-335 + configs/trainer.gin).
    extra_losses: Dict[str, Any] = dataclasses.field(default_factory=dict)
    finetune_cache: bool = False
    num_surface_light_field_samples: Optional[int] = None
    material_loss_radius: float = float("inf")
    emission_radius: float = float("inf")
    light_sampling_loss_weight: float = 0.0
    light_sampling_loss_type: str = "rawnerf_original"
    emission_zero_loss_weight: float = 0.0
    emission_constant_loss_weight: float = 0.0
    residual_albedo_loss_weight: float = 0.0
    maximum_radiance_loss_weight: float = 0.0
    normalize_weight_loss_weight: float = 0.0
    extra_ray_regularizer: bool = False
    extra_ray_loss_mult: float = 0.0
    extra_ray_light_shuffle: bool = True
    extra_ray_type: str = "incoming"
    whitening_loss_weight: float = 0.0
    irradiance_cache_loss_weight: float = 0.0
    irradiance_cache_color_loss_weight: float = 0.0
    irradiance_cache_stopgrad_weight: float = 0.0
    irradiance_cache_stopgrad_weight_backwards: float = 1.0

    # Surface light field losses
    surface_light_field_loss_weight: float = 0.0
    surface_light_field_loss_type: str = "mse"
    surface_light_field_loss_depth_scale: float = 0.0
    surface_light_field_loss_acc_scale_opaque: float = 0.0
    surface_light_field_loss_acc_scale_empty: float = 0.0
    surface_light_field_loss_bound_scale: float = 0.0
    surface_light_field_loss_bounce: bool = False
    surface_light_field_loss_outward: bool = False
    surface_light_field_loss_near: float = 0.0
    surface_light_field_loss_far: float = float("inf")
    surface_light_field_loss_radius: float = float("inf")
    surface_light_field_importance_sample_weights: bool = False
    surface_light_field_stopgrad_weight_forward: float = 0.0
    surface_light_field_stopgrad_weight_backward: float = 1.0

    # Geometry stopgrads (cache vs material stages)
    stopgrad_cache_geometry: bool = False
    stopgrad_cache_geometry_weight: float = 0.0
    stopgrad_cache_geometry_feature_weight: float = 0.0
    stopgrad_cache_geometry_normals_weight: float = 0.0

    # --- Eval / render ---
    render_chunk_size: int = 16384
    render_repeats: int = 1
    eval_render_interval: int = 1
    eval_dataset_limit: int = 2147483647
    eval_quantize_metrics: bool = True
    eval_crop_borders: int = 0
    num_showcase_images: int = 5
    vis_num_rays: int = 16
    vis_decimate: int = 0
    metric_harness_train_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metric_harness_eval_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # Misc parity fields
    calib_checkpoint: str = ""
    optimize_calib_on_load: bool = False
    use_vignette: bool = False
    light_static_wrt: str = "camera"
    optimize_cameras: bool = False
    optimize_test_cameras: bool = False

    # Seeds
    jax_rng_seed: int = 20200823  # the Trainer's torch generators' seed
    np_rng_seed: int = 20201473


def register_all_configurables():
    """Import every module that defines gin configurables.

    Gin names resolve at parse time, so the class registry (models,
    trainer) must be imported before a config file that names them is
    parsed.
    """
    import importlib

    for mod in (
        "neural_radiance_caching_tpu_torch.models.grids",
        "neural_radiance_caching_tpu_torch.models.geometry",
        "neural_radiance_caching_tpu_torch.models.sampler",
        "neural_radiance_caching_tpu_torch.models.surface_light_field",
        "neural_radiance_caching_tpu_torch.models.nerf_shader",
        "neural_radiance_caching_tpu_torch.models.integrator",
        "neural_radiance_caching_tpu_torch.models.nerf_model",
        "neural_radiance_caching_tpu_torch.models.light_sampler",
        "neural_radiance_caching_tpu_torch.models.material_shader",
        "neural_radiance_caching_tpu_torch.models.material_model",
        "neural_radiance_caching_tpu_torch.engine.trainer",
    ):
        importlib.import_module(mod)


def load_config(config_files=(), bindings=()) -> Config:
    """Parse gin files and bindings, then construct the bound Config."""
    register_all_configurables()
    gin.parse_config_files_and_bindings(config_files=config_files, bindings=bindings)
    return Config()
