"""Torch-side ``Config`` (counterpart of ``engine/configs.py``).

Same field names and defaults as the JAX ``Config``, for the fields the
cache, material, transient cache and transient material slices read. The
gin surface comes with
the config engine in a later port step; until then a Config is built with
keyword arguments.

The eval fields (``render_chunk_size``, ``render_repeats``,
``compute_depth_metrics``, ``material_normals_target``,
``evaluate_without_masks``) are read by ``engine/renderer.py`` and
``engine/trainer.py``; ``use_shift_invariance`` raises when set, until the
shift-invariant metrics are ported.

One field is the port's own: ``transient_shift_form`` picks how the
transient integrator shifts and sums the per-sample indirect transients
(``"gather"``, ``"fft"`` or ``"matmul"``, see ``ops/render.py``), per call
from the Config. It takes the place of the JAX package's process-global
``set_fft_transient_shift`` / ``set_spectral_backend``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Config:
    # --- Dataset ---
    batch_size: int = 16384
    patch_size: int = 1
    factor: int = 0
    num_dataset_images: int = -1
    synthetic_spheres_shading: str = "legacy"
    synthetic_spheres_multi_illum: bool = False
    synthetic_spheres_impulse_sigma: float = 0.0
    near: float = 2.0
    far: float = 6.0
    secondary_far: float = 2.0
    light_near: float = 0.0
    cast_rays_in_train_step: bool = False
    np_rng_seed: int = 20201473

    # --- Model selection ---
    use_transient: bool = False
    num_rgb_channels: int = 3
    linear_to_srgb: bool = False
    multi_illumination: bool = False
    volume_variate: bool = False
    volume_variate_secondary: bool = False
    volume_variate_material: bool = False
    learnable_light: bool = False
    use_ground_truth_illumination: bool = False
    compute_relight_metrics: bool = False

    # --- Transient ---
    n_bins: int = 700
    exposure_time: float = 0.01
    transient_shift: float = 0.0
    dark_level: float = 0.0
    tfilter_sigma: float = 0.0
    filter_indirect: bool = False
    filter_median: bool = False
    filter_median_thresh: float = 0.0
    no_shift_direct: bool = False
    vis_only: bool = False
    use_itof: bool = False
    transient_gauss_sigma_scales: List[Any] = dataclasses.field(default_factory=list)
    light_source_position: Optional[List[float]] = None
    dark_level_multiplier: float = 1.0
    transient_shift_multiplier: float = 1.0
    light_pos_multiplier: float = 1.0
    transient_shift_form: str = "fft"

    # --- Active lighting ---
    use_falloff: bool = True
    light_zero: bool = True
    light_intensity_conditioning: bool = False
    light_intensity_conditioning_scale: float = 1.0
    light_intensity_conditioning_bias: float = 0.0
    light_canonical_frame: bool = False
    sl_relight: bool = False
    bin_zero_threshold_light: float = 2.0
    use_occlusions: bool = False
    occlusions_secondary_only: bool = True
    occlusions_primary_only: bool = True

    # --- Material stage ---
    secondary_normal_eps: float = 1e-2
    material_loss_radius: float = float("inf")
    material_normals_target: str = "normals_to_use"

    # --- Eval ---
    render_chunk_size: int = 16384
    render_repeats: int = 1
    compute_depth_metrics: bool = True
    use_shift_invariance: bool = False
    evaluate_without_masks: bool = False

    # --- Optimization ---
    max_steps: int = 25000
    lr_init: float = 0.01
    lr_final: float = 0.001
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 1e-8
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_eps: float = 1e-15
    grad_max_norm: float = 0.0
    grad_max_val: float = 0.0
    grad_accum_steps: int = 1
    extra_opt_params: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    use_gradient_debias: bool = False
    gradient_checkpointing: bool = False
    debug_mode: bool = False

    # --- Data losses ---
    data_loss_type: str = "charb"
    data_loss_mult: float = 1.0
    charb_padding: float = 0.001
    rawnerf_exponent: int = 1
    rawnerf_exponent_material: int = 1
    rawnerf_eps: float = 1e-2
    rawnerf_eps_material: float = 1e-2
    use_gt_rawnerf: bool = False
    use_combined_rawnerf: bool = False
    use_norm_rawnerf: bool = False
    convert_srgb: bool = False
    is_material: bool = False
    use_loss_clip: bool = False
    loss_clip_min: float = 0.0
    loss_thresh: float = float("inf")
    loss_clip: float = float("inf")
    mask_lossmult: bool = True
    mask_lossmult_weight: float = 0.0
    clip_eval: bool = False
    opaque_loss_weight: float = 0.0
    empty_loss_weight: float = 0.0
    patch_loss_mult: float = 0.0

    # --- Geometry / sampler losses ---
    use_spline_interlevel_loss: bool = True
    interlevel_loss_mults: Tuple[float, ...] = (0.01, 0.01)
    interlevel_loss_blurs: Tuple[float, ...] = (0.03, 0.003)
    distortion_loss_mult: float = 0.0
    distortion_loss_target: str = "tdist"
    distortion_loss_curve_fn: Optional[Tuple[Callable, Dict[str, Any]]] = None
    normalize_distortion_loss: bool = False
    orientation_loss_mult: float = 0.0
    predicted_normal_loss_mult: float = 0.0
    predicted_normal_reverse_loss_mult: float = 0.0
    predicted_normal_loss_normalize: bool = False
    predicted_normal_loss_stopgrad: bool = False
    predicted_normal_loss_stopgrad_weight: float = 1.0
    use_normal_weight_ease: bool = False
    use_normal_weight_ease_backward: bool = False
    normal_weight_ease_frac: float = 0.0
    normal_weight_ease_start: float = 0.0
    normal_weight_ease_min: float = 0.0
    use_normal_weight_decay: bool = False
    use_normal_weight_decay_backward: bool = False
    normal_weight_decay_start: float = 0.0
    normal_weight_decay_frac: float = 0.1
    normal_weight_decay_min: float = 0.01
    eikonal_loss_mult: float = 0.0
    eikonal_coarse_loss_mult: float = 0.0
    param_regularizers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # {loss_name: {output_key: {"mult": float, "start_frac": float}}}; only
    # "direct_indirect_consistency" is ported (parallel/extra_losses.py).
    extra_losses: Dict[str, Any] = dataclasses.field(default_factory=dict)
    maximum_radiance_loss_weight: float = 0.0
    normalize_weight_loss_weight: float = 0.0
    material_correlation_weight_albedo: float = 0.0
    material_correlation_weight_other: float = 0.0
    extra_ray_loss_mult: float = 0.0

    # --- Cache/material consistency (the direct_indirect_consistency loss) ---
    # loss_weight is the multiplier the staged trainer binds into
    # extra_losses (flagship.trainer_consistency_losses).
    cache_consistency_loss_type: str = "charb"
    cache_consistency_use_integrated: bool = True
    cache_consistency_loss_weight: float = 0.0
    cache_consistency_stopgrad_weight_cache: float = 1.0
    cache_consistency_stopgrad_weight_material: float = 0.0
    cache_consistency_direct_weight: float = 1.0
    cache_consistency_indirect_weight: float = 1.0
    use_consistency_weight_ease: bool = False
    consistency_weight_ease_frac: float = 0.0
    consistency_weight_ease_start: float = 0.0
    consistency_weight_ease_min: float = 0.0

    def __post_init__(self):
        if self.use_shift_invariance:
            raise NotImplementedError("the shift-invariant eval metrics are not ported yet")
