"""Multi-stage training orchestrator (counterpart of ``engine/trainer.py``).

The ``Trainer`` drives the staged recipe: each ``stage`` (cache -> light /
surface_light_field -> material*) selects a ``stage_params`` entry
(``configs/trainer.gin``), synthesizes gin bindings (steps and learning
rates rescaled by the batch ratio, per-module optimizer overrides, the
stage's extra losses and model flags), re-binds the Config, builds the
model on its device (the card unless ``device="cpu"``), and runs the train
loop with periodic checkpoints and test-set evaluation. Stage warm starts
are prefix-filtered restores on the JAX parameter paths (the material
stage pulls ``params/Cache`` from the cache stage and keeps a fresh
``params/MaterialShader``).

The loop is eager: one host fetch per ``print_every`` interval reads the
losses of the steps since the last one; batches are drawn and moved to the
device on a background thread (``RayBatcher``), one step ahead.

Every stage of ``configs/trainer.gin`` trains on the steady configs (the
surface-light-field stages with resampling, ``Trainer.resample`` and
``resample_render``: the SLF variate sums one surface point per ray), and
every stage but the material SLF ones on the transient configs (the JAX
package's transient cache has no SLF memory). Each step of the loop takes
``Config.grad_accum_steps`` micro-steps of the train step (times
``Config.secondary_grad_accum_steps``, that many of them on one batch),
and a checkpoint keeps the gradient accumulated so far. An evaluation of a transient view
saves its transient as an h5 file (``data/hdf5.write_h5``) and one time
slice of it. An evaluation scores PSNR, SSIM and LPIPS (the metric
harness, built at the first evaluation on the trainer's device) and, under
``Config.use_shift_invariance``, the best-shift PSNR. With
``vis_secondary`` it also renders the secondary-ray probe (a panorama seen
from one surface point of the view) and saves its vis suite. Under
``Config.profile_dir`` the steps [profile_start_step, profile_start_step +
profile_num_steps) are traced by torch.profiler (host and, on the card,
its kernels) into a Chrome trace there. The viewer raises.

Under ``torchrun`` the trainer is one rank of a data-parallel group
(``parallel/mesh.py``; NCCL on the card, gloo on the CPU, each rank on
``cuda:LOCAL_RANK``): every rank draws its own ``batch_size // world`` rays
(numpy seeded ``np_rng_seed + rank``), its train step averages the gradients
over the ranks, and the step counts, schedules and rays/s are the global
batch's. Rank 0's parameters and optimizer state are broadcast at setup and
after every restore or warm start; every rank renders its share of each
evaluation. Only rank 0 writes: ``config.gin``, checkpoints,
``train_log.jsonl``, evaluation images and h5 files, results.txt and the
profile trace; the others wait at a barrier where it writes. A world of one
with no ``torchrun`` environment trains as one process.

``render_test_view`` and ``compute_eval_metrics`` are also module-level
functions that take what they read from the trainer as arguments.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.data import camera_utils, datasets, hdf5
from neural_radiance_caching_tpu_torch.engine import configs as configs_lib
from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.engine import renderer
from neural_radiance_caching_tpu_torch.ops import image as image_lib
from neural_radiance_caching_tpu_torch.ops import render_utils
from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.parallel import train as train_lib
from neural_radiance_caching_tpu_torch.utils import checkpoints as ckpt_lib
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil
from neural_radiance_caching_tpu_torch.utils import vis as vis_lib


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# The transients of a rendering that no evaluation reads (its metrics, vis
# suites and saves read rgb, cache_rgb and transient_indirect): never copied
# to the host, where at 512^2 x 700 bins the per-sample one alone would take
# 70 GB.
EVAL_UNREAD = ("transient_direct", "transient_direct_no_filter", "transient_direct_viz",
               "transient_indirect_diffuse", "transient_indirect_specular",
               "transient_indirect_no_filter", "transient_indirect_viz",
               "transient_indirect_no_integration")


def render_test_view(render_fn, dataset, cam_idx, rng, config, train_frac=1.0):
    """Render one view of `dataset` (all its pixels, ``config.render_repeats``
    draws each); returns (rendering dict of [H, W, ...] host arrays, the
    view's batch). The outputs in EVAL_UNREAD stay on the device."""
    batch = dataset.generate_ray_batch(cam_idx)
    if isinstance(batch.rays, pytrees.Pixels):
        # In-step casting ships Pixels; an eval view is cast on the host
        # (lens distortion and the NDC warp too), without jitter, as in JAX.
        pixels = pytrees.Pixels(**{f.name: None if getattr(batch.rays, f.name) is None
                                   else _host(getattr(batch.rays, f.name))
                                   for f in dataclasses.fields(batch.rays)})
        rays = camera_utils.cast_ray_batch(dataset.cameras, dataset.lights, pixels,
                                           impulse_response=dataset.impulse_response,
                                           virtual_camtoworlds=dataset.virtual_camtoworlds)
        batch = batch.replace(rays=rays.to(dataset.device))
    rendering = renderer.render_image(
        render_fn, batch.rays, rng, config, height=dataset.height, width=dataset.width,
        train_frac=train_frac, render_repeats=config.render_repeats, exclude=EVAL_UNREAD,
        device=dataset.device)
    return rendering, batch


def compute_eval_metrics(rendering, batch, height, width, config, metric_harness, postprocess_fn,
                         albedo_ratio=None, albedo_clip=1.0):
    """The harness's metrics (PSNR, SSIM, LPIPS), the shift-invariant PSNR
    under ``use_shift_invariance``, the normal mean angular error, the depth
    L1 (median and mean), the albedo PSNR and the transient IoU of one
    rendered view.

    albedo_ratio: the run-level albedo calibration [1, 3], or None for the
    per-image least-squares ratio.
    """
    metrics = {}
    gt = _host(batch.rgb)
    gt = gt.reshape((height, width) + gt.shape[1:])

    if "rgb" in rendering:
        pred = postprocess_fn(np.asarray(rendering["rgb"]))
        gt_pp = postprocess_fn(gt)
        if gt_pp.shape == pred.shape:
            metrics.update(metric_harness(pred, gt_pp))
            if config.use_shift_invariance and pred.ndim == 3:
                # The best-shift PSNR over an integer-pixel search window.
                radius = max(abs(config.shift_invariant_start), abs(config.shift_invariant_end))
                si_mse, _, _ = image_lib.shift_invariant_mse(pred, gt_pp, (radius, radius), 2)
                metrics["psnr_shift_invariant"] = float(-10.0 * np.log10(float(si_mse) + 1e-12))

    masks = (_host(batch.masks).reshape(height, width, -1)[..., :1]
             if batch.masks is not None else np.ones((height, width, 1), np.float32))

    if batch.normals is not None and ("normals" in rendering or "normals_to_use" in rendering):
        normals_gt = _host(batch.normals).reshape(-1, 3) + (1.0 - masks.reshape(-1, 1))
        norm = np.linalg.norm(normals_gt, axis=-1, keepdims=True)
        normals_gt = np.where(norm < 1e-5, 0.0, normals_gt / np.maximum(norm, 1e-12))
        key = "normals" if config.material_normals_target == "normals" else (
            "normals_to_use" if "normals_to_use" in rendering else "normals")
        acc = np.asarray(rendering.get("acc", np.ones((height, width)))).reshape(-1, 1)
        normals = np.asarray(rendering[key]).reshape(-1, 3) + (1.0 - acc)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = np.where(norm < 1e-5, 0.0, normals / np.maximum(norm, 1e-12))
        angles = np.arccos(np.clip(np.sum(normals_gt * normals, axis=-1), -1, 1)) * 180 / np.pi
        if config.evaluate_without_masks:
            metrics["mae"] = float(np.mean(angles))
        else:
            metrics["mae"] = float(np.mean(angles * masks.reshape(-1)))

    if config.compute_depth_metrics and batch.depth is not None and "distance_mean" in rendering:
        depth_gt = _host(batch.depth).reshape(height, width)
        for key, name in (("distance_median", "l1_median"), ("distance_mean", "l1_mean")):
            if key not in rendering:
                continue
            l1 = np.abs(np.asarray(rendering[key]).reshape(height, width) - depth_gt)
            if config.evaluate_without_masks:
                metrics[name] = float(np.mean(l1))
            else:
                metrics[name] = float((l1 * masks[..., 0]).sum() / masks.sum())

    if batch.albedos is not None and "material_albedo" in rendering:
        albedo_gt = _host(batch.albedos).reshape(-1, 3)
        albedo = np.clip(np.asarray(rendering["material_albedo"]).reshape(-1, 3), 0.0,
                         albedo_clip)
        m = masks.reshape(-1) > 0.5
        if m.any():
            if albedo_ratio is None:
                # Per-image least-squares colour calibration.
                num = (albedo_gt[m] * albedo[m]).sum(axis=0)
                den = np.maximum((albedo[m] ** 2).sum(axis=0), 1e-8)
                ratio = (num / den).reshape(1, 3)
            else:
                ratio = albedo_ratio
            calibrated = np.clip(albedo * ratio, 0.0, 1.0)
            mse = np.mean((calibrated[m] - np.clip(albedo_gt[m], 0, 1)) ** 2)
            metrics["albedo_psnr"] = float(-10.0 * np.log10(mse + 1e-12))

    if config.use_transient and "cache_rgb" in rendering and gt.ndim == 4:
        pred_t = vis_lib.finite(rendering["cache_rgb"])
        gt_t = gt[..., :3]
        if pred_t.shape == gt_t.shape:
            inter = np.minimum(pred_t, gt_t).sum()
            union = np.maximum(pred_t, gt_t).sum()
            metrics["transient_iou"] = float(inter / max(union, 1e-12))
    return metrics


class RayBatcher:
    """Training batches drawn by a background thread, one step ahead (on the
    dataset's device)."""

    def __init__(self, dataset, queue_size=2):
        self._queue = queue.Queue(queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(dataset,), daemon=True)
        self._thread.start()

    def _run(self, dataset):
        while not self._stop.is_set():
            try:
                batch = dataset.next_train()
            except Exception as e:  # surfaced to the consumer by __next__
                batch = e
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._queue.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def stop(self):
        self._stop.set()
        self._thread.join()


# Minimal built-in registry; configs/trainer.gin binds the full one.
_DEFAULT_STAGE_PARAMS = {
    "cache": {
        "render_chunk_size": 4096,
        "use_light_sampler": False,
        "use_material": False,
        "use_surface_light_field": False,
        "optimize_cache": True,
        "optimize_light": False,
        "optimize_surface_light_field": False,
        "reduce_cache_factor": 1.0,
        "reduce_surface_light_field_factor": 1.0,
        "prefixes": None,
        "exclude_prefixes": None,
        "replace_dict": None,
        "extra_losses": {},
    },
}


def _linear_to_srgb_postprocess(exposure, config):
    def p_fn(x):
        if len(x.shape) == 4:  # transient [H, W, T, C] -> integrate time
            x = x.sum(-2)
            x = np.clip(x / config.img_scale, 0, 1)
        if x.shape[-1] == 1:
            x = np.tile(x, (1,) * (len(x.shape) - 1) + (3,))
        return vis_lib.linear_to_srgb(x * exposure)

    return p_fn


@gin.configurable
@dataclasses.dataclass
class Trainer:
    """Stage-driven trainer; ``device`` is where the model and the batches
    live (the card unless the caller asks for the CPU)."""

    # Core configuration
    stage: str = "cache"
    viewer_only: bool = False
    relight: bool = False
    save_results: bool = True

    # Albedo processing options
    albedo_clip: float = 1.0
    albedo_correct_median: bool = False
    albedo_gamma: bool = True

    # Visualization options
    vis_only: bool = False
    vis_restart: bool = False
    vis_start: int = 0
    vis_end: int = 200
    vis_secondary: bool = False
    vis_extra: bool = False
    vis_surface_light_field: bool = False
    vis_light_sampler: bool = False

    # Training options
    stopgrad: bool = False
    resample: bool = False
    resample_depth: bool = False
    sample_factor: int = 2
    num_resample: int = 1
    resample_render: bool = False
    sample_render_factor: int = 2
    render_repeats: int = 1

    stage_params: Optional[Dict[str, Any]] = None
    device: str = "cuda"

    # --- setup ------------------------------------------------------------------

    @property
    def rank(self):
        """This process's rank in the data-parallel group (0 without one)."""
        return mesh_lib.process_index()

    def setup(self):
        torchutil.check_device(self.device, "the trainer", "run it on the CPU")
        mesh = mesh_lib.create_mesh(self.device)
        self.device = mesh.device
        if mesh.backend is not None and self.rank == 0:
            print(f"data-parallel group: {mesh.world_size} rank(s), {mesh.backend}, "
                  f"rank 0 on {self.device}", flush=True)
        if self.stage_params is None:
            self.stage_params = dict(_DEFAULT_STAGE_PARAMS)
        if self.stage not in self.stage_params:
            raise ValueError(
                f"Unknown stage {self.stage!r}; known: {sorted(self.stage_params)}")
        self._setup_names()
        self._setup_config_parameters()
        self._setup_binding_configs()
        self._setup_rng()
        self._load_datasets()
        self._setup_model()
        self._setup_checkpointing()
        self._initialize_metrics()

    def _query(self, name, default=None):
        return gin.query_parameter(name, default)

    def _setup_names(self):
        self.use_transient = bool(self._query("Config.use_transient", False))
        if self.use_transient:
            self.nerf_mlp_name = "TransientNeRFMLP"
            self.nerf_model_name = "TransientNeRFModel"
            self.material_mlp_name = "TransientMaterialMLP"
            self.material_model_name = "TransientMaterialModel"
        else:
            self.nerf_mlp_name = "NeRFMLP"
            self.nerf_model_name = "NeRFModel"
            self.material_mlp_name = "MaterialMLP"
            self.material_model_name = "MaterialModel"

    def _setup_config_parameters(self):
        sp = self.stage_params[self.stage]
        q = self._query

        self.checkpoint_dir = q("Config.checkpoint_dir", None)
        self.calib_checkpoint = q("Config.calib_checkpoint", "")
        self.optimize_calib_on_load = q("Config.optimize_calib_on_load", False)

        self.secondary_grad_accum_steps = sp.get(
            "secondary_grad_accum_steps", q("Config.secondary_grad_accum_steps", 1))
        self.grad_accum_steps = (
            sp.get("grad_accum_steps", q("Config.grad_accum_steps", 1))
            * self.secondary_grad_accum_steps)

        # Feature flags
        self.use_material = sp["use_material"]
        self.use_light_sampler = sp["use_light_sampler"]
        self.use_surface_light_field = sp["use_surface_light_field"]
        self.optimize_cache = sp["optimize_cache"]
        self.optimize_light = sp["optimize_light"]
        self.optimize_surface_light_field = sp["optimize_surface_light_field"]
        self.optimize_geometry = sp.get("optimize_geometry", True)
        self.use_geometry_smoothness = q("Config.use_geometry_smoothness", False)
        self.stopgrad_cache_geometry = (
            q("Config.stopgrad_cache_geometry", False)
            and self.use_material
            and ("from_scratch" not in self.stage))

        # Occlusions
        self.use_occlusions = q("Config.use_occlusions", False)
        self.occlusions_secondary_only = q("Config.occlusions_secondary_only", True)
        self.occlusions_primary_only = q("Config.occlusions_primary_only", True)
        self.light_near = q("Config.light_near", 0.05)
        if self.vis_only:
            self.use_occlusions = True
            self.occlusions_secondary_only = False
            self.occlusions_primary_only = False
            self.light_near = q("Config.near", 0.0)
        if "finetune" in self.stage:
            self.use_occlusions = True
            self.occlusions_secondary_only = False
            self.occlusions_primary_only = False

        # Learning-rate / schedule scaling: steps and learning rates rescale
        # with the ratio of the base batch to the actual one.
        self.factor = q("Config.factor", 0)
        self.base_batch_size = q("Config.base_batch_size", 65536)
        self.batch_size = q("Config.batch_size", 16384)
        self.render_chunk_size = sp.get(
            "render_chunk_size", q("Config.render_chunk_size", 16384))
        self.train_length_mult = max(1, q("Config.train_length_mult", 1))
        self.scale_factor = max(
            1,
            self.base_batch_size
            // max(1, (self.batch_size * self.grad_accum_steps)
                   // self.secondary_grad_accum_steps))
        self.total_batch_size = self.batch_size * self.grad_accum_steps
        self.lr_factor = q("Config.lr_factor", 1.0) * q("Config.lr_factor_mult", 1.0)
        self.max_steps = (q("Config.max_steps", 25000) * self.scale_factor
                          ) // self.train_length_mult
        self.lr_delay_steps = (q("Config.lr_delay_steps", 2500) * self.scale_factor
                               ) // self.train_length_mult
        self.lr_init = (q("Config.lr_init", 0.01) / self.scale_factor) * self.lr_factor
        self.lr_final = (q("Config.lr_final", 0.001) / self.scale_factor) * self.lr_factor
        self.extra_opt_params = copy.deepcopy(q("Config.extra_opt_params", {}))

        # Loss parameters
        self.cache_consistency_loss_weight = q("Config.cache_consistency_loss_weight", 0.0)
        self.cache_consistency_loss_type = q("Config.cache_consistency_loss_type", "charb")
        self.finetune_multiplier = sp.get(
            "finetune_multiplier", q("Config.finetune_multiplier", 10.0))
        self.finetune_cache = False
        self.reduce_cache_factor = sp["reduce_cache_factor"]
        self.reduce_surface_light_field_factor = sp["reduce_surface_light_field_factor"]
        self.anneal_slope = sp.get(
            "anneal_slope", q("ProposalVolumeSampler.anneal_slope", 10.0))
        self.material_interlevel_loss_mults = q(
            "Config.material_interlevel_loss_mults", (0.0, 0.0))
        self.material_predicted_normal_loss_mult = q(
            "Config.material_predicted_normal_loss_mult", 1.0)
        self.prefixes = sp.get("prefixes")
        self.exclude_prefixes = list(sp.get("exclude_prefixes") or [])
        self.replace_dict = sp.get("replace_dict")
        self.extra_losses = dict(sp.get("extra_losses", {}))
        self.param_regularizers = sp.get(
            "param_regularizers", q("Config.param_regularizers", {}))

        # Sampling parameters
        self.num_secondary_samples = sp.get(
            "num_secondary_samples",
            q(f"{self.material_mlp_name}.num_secondary_samples", None))
        self.num_secondary_samples_render = sp.get(
            "num_secondary_samples_render", self.num_secondary_samples)
        self.num_secondary_samples_diff = sp.get(
            "num_secondary_samples_diff",
            q(f"{self.material_mlp_name}.num_secondary_samples_diff", None))
        self.num_secondary_samples_diff_render = sp.get(
            "num_secondary_samples_diff_render", self.num_secondary_samples_diff)
        self.num_surface_light_field_samples = sp.get("num_surface_light_field_samples", None)
        self.slf_variate = (
            sp.get("slf_variate", q(f"{self.material_model_name}.slf_variate", False))
            and self.use_surface_light_field)
        self.surface_light_field_loss_far = sp.get("surface_light_field_loss_far")
        self.surface_light_field_loss_radius = sp.get("surface_light_field_loss_radius")
        if self.num_secondary_samples_render is not None:
            self.num_secondary_samples_render *= self.sample_render_factor
        if self.num_secondary_samples is not None:
            self.num_secondary_samples *= self.sample_factor
        if self.num_secondary_samples_diff_render is not None:
            self.num_secondary_samples_diff_render *= self.sample_render_factor
        if self.num_secondary_samples_diff is not None:
            self.num_secondary_samples_diff *= self.sample_factor

    def _process_extra_losses(self):
        if self.slf_variate:
            self.extra_losses["material_surface_light_field"] = {
                "main": {"mult": 1.0, "start_frac": 0.0}}
            self.extra_losses.pop("surface_light_field", None)
        if self.use_geometry_smoothness:
            if not self.use_material:
                self.extra_losses["geometry_smoothness"] = {
                    "main": {"mult": 1.0, "start_frac": 0.0}}
            elif "from_scratch" in self.stage:
                self.extra_losses["geometry_smoothness"] = {
                    "cache_main": {"mult": 1.0, "start_frac": 0.0}}
        if self.use_material:
            self.extra_losses["direct_indirect_consistency"] = {
                "main": {"mult": self.cache_consistency_loss_weight, "start_frac": 0.0}}

    def _process_opt_params(self):
        """Scale the per-module learning-rate overrides, select their
        ``_material`` entries, and freeze the modules the stage does not
        optimize."""
        out = {}
        for mod, params in (self.extra_opt_params or {}).items():
            p = dict(params)
            for k in list(p):
                if k.startswith("lr_init") or k.startswith("lr_final"):
                    p[k] = (p[k] / self.scale_factor) * self.lr_factor
                elif k.startswith("lr_delay_steps"):
                    p[k] = (p[k] * self.scale_factor) // self.train_length_mult
            out[mod] = p
        self.extra_opt_params = out

        if self.use_material and ("from_scratch" not in self.stage):
            for p in self.extra_opt_params.values():
                for k in ("lr_delay_steps", "lr_init", "lr_final"):
                    if f"{k}_material" in p:
                        p[k] = p[f"{k}_material"]

        def disable(keys):
            for k in keys:
                self.extra_opt_params[k] = {"lr_delay_steps": 0, "lr_final": 0.0, "lr_init": 0.0}

        if self.calib_checkpoint and not self.optimize_calib_on_load:
            disable(["VignetteMap"])
        if not self.optimize_geometry:
            disable(["Sampler", "MLP_1", "MLP_2", "density_grid"])
        if "finetune" in self.stage:
            self.param_regularizers = None
            self.finetune_cache = True
            self.cache_consistency_loss_weight *= self.finetune_multiplier
            disable(["Sampler", "MLP_1", "MLP_2", "density_grid",
                     "MaterialShader", "VignetteMap", "LightSource"])
        if not self.optimize_cache:
            disable(["Cache", "SurfaceLightField", "PersonLightField"])
        if not self.optimize_light:
            disable(["LightSampler"])
        if not self.optimize_surface_light_field:
            disable(["SurfaceLightFieldMem"])

    def _setup_binding_configs(self):
        """Synthesize the stage's bindings and rebuild the Config."""
        self._process_extra_losses()
        self._process_opt_params()

        b = [
            f"Config.max_steps = {self.max_steps}",
            f"Config.batch_size = {self.batch_size}",
            f"Config.grad_accum_steps = {self.grad_accum_steps}",
            f"Config.lr_init = {self.lr_init}",
            f"Config.lr_final = {self.lr_final}",
            f"Config.lr_delay_steps = {self.lr_delay_steps}",
            # (extra_opt_params / extra_losses / param_regularizers are bound
            # directly below: they can hold function objects whose repr()
            # does not round-trip through the gin parser.)
            f"Config.finetune_cache = {self.finetune_cache}",
            f"Config.cache_consistency_loss_type = {self.cache_consistency_loss_type!r}",
            f"Config.cache_consistency_loss_weight = {self.cache_consistency_loss_weight}",
            f"Config.use_occlusions = {self.use_occlusions}",
            f"Config.occlusions_secondary_only = {self.occlusions_secondary_only}",
            f"Config.occlusions_primary_only = {self.occlusions_primary_only}",
            f"Config.light_near = {self.light_near}",
            f"{self.material_model_name}.use_material = {self.use_material}",
            f"{self.material_model_name}.use_light_sampler = {self.use_light_sampler}",
            f"{self.material_model_name}.use_surface_light_field = "
            f"{self.use_surface_light_field}",
            f"ProposalVolumeSampler.anneal_slope = {self.anneal_slope}",
        ]
        if self.use_material:
            b.append("Config.model_type = %ModelType.MATERIAL")
            b.append("Config.is_material = True")
        if self.vis_only:
            b.append(f"Config.test_factor = {self.factor}")
        if self.use_material and "from_scratch" not in self.stage:
            pn = self._query("Config.predicted_normal_loss_mult", 0.0)
            pnr = self._query("Config.predicted_normal_reverse_loss_mult", 0.0)
            b += [
                "Config.occ_threshold_start_frac = 0.0",
                "Config.occ_threshold_rate = 0.0",
                "Config.shadow_near_start_frac = 0.0",
                "Config.shadow_near_rate = 0.0",
                f"{self.material_mlp_name}.near_start_frac = 0.0",
                f"{self.material_mlp_name}.near_rate = 0.0",
                "Config.use_normal_weight_ease = False",
                "Config.use_normal_weight_ease_backward = False",
                "Config.use_material_weight_ease = False",
                "Config.use_consistency_weight_ease = False",
                "Config.use_surface_light_field_weight_ease = False",
                f"Config.interlevel_loss_mults = {tuple(self.material_interlevel_loss_mults)!r}",
                f"Config.predicted_normal_loss_mult = "
                f"{pn * self.material_predicted_normal_loss_mult}",
                f"Config.predicted_normal_reverse_loss_mult = "
                f"{pnr * self.material_predicted_normal_loss_mult}",
            ]
        if self.stopgrad_cache_geometry:
            b += [
                f"{self.nerf_model_name}.stopgrad_geometry_weight = "
                f"{self._query('Config.stopgrad_cache_geometry_weight', 0.0)}",
                f"{self.nerf_model_name}.stopgrad_geometry_feature_weight = "
                f"{self._query('Config.stopgrad_cache_geometry_feature_weight', 1.0)}",
                f"{self.nerf_model_name}.stopgrad_geometry_normals_weight = "
                f"{self._query('Config.stopgrad_cache_geometry_normals_weight', 1.0)}",
            ]
        if self.stopgrad:
            b += [
                f"{self.material_mlp_name}.stopgrad_rays = True",
                f"{self.material_mlp_name}.stopgrad_samples = True",
                "Config.cache_consistency_stopgrad_weight_cache = 0.0",
            ]
        if self.resample_render:
            b.append(f"{self.material_model_name}.resample_render = True")
        if self.resample:
            b += [
                f"{self.material_model_name}.resample = {self.resample}",
                f"{self.material_model_name}.num_resample = {self.num_resample}",
                f"{self.material_model_name}.use_resample_depth = {self.resample_depth}",
            ]
        if self.render_chunk_size is not None:
            b.append(f"Config.render_chunk_size = {self.render_chunk_size}")
        if self.surface_light_field_loss_far is not None:
            b.append(f"Config.surface_light_field_loss_far = {self.surface_light_field_loss_far}")
        if self.surface_light_field_loss_radius is not None:
            b.append(f"Config.surface_light_field_loss_radius = "
                     f"{self.surface_light_field_loss_radius}")
        if self.slf_variate is not None:
            b.append(f"{self.material_model_name}.slf_variate = {self.slf_variate}")
        if self.num_secondary_samples is not None:
            b += [
                f"{self.material_mlp_name}.num_secondary_samples = {self.num_secondary_samples}",
                f"{self.material_mlp_name}.render_num_secondary_samples = "
                f"{self.num_secondary_samples_render}",
            ]
            if self.num_secondary_samples_diff is not None:
                b += [
                    f"{self.material_mlp_name}.num_secondary_samples_diff = "
                    f"{self.num_secondary_samples_diff}",
                    f"{self.material_mlp_name}.render_num_secondary_samples_diff = "
                    f"{self.num_secondary_samples_diff_render}",
                ]
        if self.num_surface_light_field_samples is not None:
            b.append(f"Config.num_surface_light_field_samples = "
                     f"{self.num_surface_light_field_samples}")
        if not self.optimize_cache:
            b.append(f"{self.material_mlp_name}.enable_normals_offset = False")

        self.bindings = b
        gin.parse_config("\n".join(b))
        # Object-valued bindings (may contain function references).
        gin.bind("Config", "extra_opt_params", self.extra_opt_params)
        gin.bind("Config", "extra_losses", self.extra_losses)
        if self.param_regularizers is not None:
            gin.bind("Config", "param_regularizers", self.param_regularizers)
        self.config = configs_lib.Config()
        if self.config.checkpoint_dir and self.rank == 0:
            os.makedirs(self.config.checkpoint_dir, exist_ok=True)
            with open(os.path.join(self.config.checkpoint_dir, "config.gin"), "w") as f:
                f.write(gin.operative_config_str())

    def _setup_rng(self):
        """Explicit generators on the device for the train and render draws,
        seeded alike on every rank (each rank keeps its block of the global
        batch's draws); the model's initial weights come from torch's default
        generator, and numpy's global state is seeded with np_rng_seed +
        rank, as JAX seeds it with the process index."""
        seed = self.config.jax_rng_seed
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.render_rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        torch.manual_seed(seed)
        np.random.seed(self.config.np_rng_seed + self.rank)

    def _load_datasets(self):
        config = self.config
        if config.y_up and config.light_source_position is not None:
            p = config.light_source_position
            config.light_source_position = [p[1], p[0], p[2]]
        self.dataset = datasets.load_dataset("train", config.data_dir, config, device=self.device)
        self.test_dataset = datasets.load_dataset("test", config.data_dir, config,
                                                  device=self.device)
        exposure = getattr(self.test_dataset, "exposure", 1.0) or 1.0
        if config.clip_eval:
            self.postprocess_fn = lambda x: np.clip(
                vis_lib.linear_to_srgb(x * exposure), 0.0, 1.0)
        else:
            self.postprocess_fn = _linear_to_srgb_postprocess(exposure, config)

    def _setup_model(self):
        (self.model, self.state, self.render_eval_fn, self.train_step, self.lr_fn) = \
            train_lib.setup_model(self.config, dataset=self.dataset, device=self.device)
        self.metric_harness = None
        if ("finetune" not in self.stage and self.use_material
                and self.config.partial_checkpoint_dir and not self.vis_only):
            self.exclude_prefixes += ["params/MaterialShader"]
        if ("finetune" in self.stage and self.config.sl_relight
                and self.config.partial_checkpoint_dir and not self.vis_only):
            self.exclude_prefixes += ["params/LightSampler"]

    def _state_tree(self):
        return {
            "step": self.state.step,
            "model": self.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "material": train_lib.is_material_model(self.model),
            "grad_accum": self.state.grad_accum,
        }

    def _setup_checkpointing(self):
        config = self.config
        self.save_dir = (os.path.join(config.checkpoint_dir, "save")
                         if config.checkpoint_dir else None)

        if config.partial_checkpoint_dir:
            source = ckpt_lib.load_params(config.partial_checkpoint_dir)
            if source is not None:
                train_lib.restore_partial_checkpoint(
                    self.model, source["model"], prefixes=self.prefixes,
                    exclude_prefixes=tuple(self.exclude_prefixes),
                    replace_dict=self.replace_dict, source_material=source["material"])
        elif config.checkpoint_dir and ckpt_lib.latest_checkpoint_step(
                config.checkpoint_dir) is not None:
            tree = ckpt_lib.load_params(config.checkpoint_dir)
            self.model.load_state_dict(tree["model"])
            self.state.optimizer.load_state_dict(tree["optimizer"])
            self.state.step = int(tree["step"])
            accum = tree.get("grad_accum")
            if accum is not None:
                params = dict(self.model.named_parameters())
                accum = {k: v.to(params[k].device) for k, v in accum.items()}
            self.state.grad_accum = accum

        if config.calib_checkpoint:
            source = ckpt_lib.load_params(config.calib_checkpoint)
            if source is not None:
                train_lib.restore_partial_checkpoint(
                    self.model, source["model"], prefixes=None,
                    exclude_prefixes=tuple(self.exclude_prefixes),
                    replace_dict={"params/VignetteMap": "params/VignetteMap"},
                    source_material=source["material"])
        mesh_lib.replicate(self.model, self.state.optimizer)

    def _initialize_metrics(self):
        self.albedo_ratio = None
        self.metric_list = {
            k: [] for k in ("albedo_psnr", "psnr", "mae", "transient_iou",
                            "l1_median", "l1_mean", "lpips", "ssim")}

    # --- checkpoint/save ----------------------------------------------------------

    def save_checkpoint(self, step, blocking=True):
        """Rank 0 writes the checkpoint; with `blocking`, the other ranks wait
        until it is on disk."""
        if not self.config.checkpoint_dir:
            return
        if self.rank == 0:
            ckpt_lib.save_checkpoint(self.config.checkpoint_dir, self._state_tree(), step,
                                     blocking=blocking)
        if blocking:
            mesh_lib.barrier()

    # --- eval -----------------------------------------------------------------

    def render_test_view(self, cam_idx, train_frac):
        """Render one held-out view; returns (rendering dict, gt batch)."""
        config = dataclasses.replace(self.config, render_repeats=self.render_repeats)
        return render_test_view(self.render_eval_fn, self.test_dataset, cam_idx,
                                self.render_rng, config, train_frac)

    def _compute_eval_metrics(self, rendering, batch, height, width):
        if self.metric_harness is None:
            self.metric_harness = image_lib.MetricHarness(
                **{"device": self.device, **(self.config.metric_harness_train_config or {})})
        return compute_eval_metrics(rendering, batch, height, width, self.config,
                                    self.metric_harness, self.postprocess_fn,
                                    albedo_ratio=self.albedo_ratio, albedo_clip=self.albedo_clip)

    # --- the secondary-ray probe ---------------------------------------------------

    def _probe_resolution(self):
        h, w = self.test_dataset.height, self.test_dataset.width
        return min(256, h), min(512, w * 2)

    def render_secondary_rays(self, rays, distance_median, normals, select_x, select_y,
                              train_frac):
        """The panoramic probe: what the cache sees from one surface point.

        The median-depth point under pixel (select_x, select_y) of the view
        `rays`, moved 0.4 along its normal, renders an equirectangular view
        (``_probe_resolution``) with the passes ("cache", "light",
        "is_secondary"), and "surface_light_field_vis" under
        ``vis_surface_light_field``; its rays carry the view's light and
        camera frame. Returns the rendering ([h, w, ...] host arrays).
        """
        height, width = self.test_dataset.height, self.test_dataset.width
        light_h, light_w = self._probe_resolution()
        _, _, light_xyz, _ = render_utils.get_sphere_directions(
            light_h, light_w, flip=self.config.flip_secondary)
        light_xyz = light_xyz.numpy()

        def pixel(a, d):
            return _host(a).reshape(height, width, d)[select_y, select_x]

        position = (pixel(rays.origins, 3) + pixel(rays.directions, 3)
                    * pixel(distance_median, 1) + 4e-1 * pixel(normals, 3))
        cam_to_world = np.eye(4, dtype=np.float32)
        cam_to_world[:3, -1] = position
        secondary = camera_utils.cast_spherical_rays(
            cam_to_world, light_h, light_w, self.config.near, self.config.secondary_far,
            light_idx=int(_host(rays.light_idx).reshape(-1)[0]))

        def first(a, d):
            return _host(a).reshape(-1, d)[0]

        def fill(ref, vec):
            return np.broadcast_to(np.asarray(vec, np.float32), np.asarray(ref).shape)

        secondary = secondary.replace(
            directions=light_xyz.reshape(secondary.directions.shape),
            viewdirs=light_xyz.reshape(secondary.viewdirs.shape),
            lights=fill(secondary.lights, first(rays.lights, 3)),
            imageplane=fill(secondary.imageplane, first(rays.imageplane, 2)),
            look=fill(secondary.look, first(rays.look, 3)),
            up=fill(secondary.up, first(rays.up, 3)),
            cam_origins=fill(secondary.cam_origins, first(rays.cam_origins, 3)),
            vcam_look=fill(secondary.vcam_look, first(rays.look, 3)),
            vcam_up=fill(secondary.vcam_up, first(rays.up, 3)),
            vcam_origins=fill(secondary.vcam_origins, first(rays.cam_origins, 3)))

        def flatten(v):
            return None if v is None else np.asarray(v).reshape((-1,) + np.shape(v)[2:])

        flat = pytrees.Rays(**{f.name: flatten(getattr(secondary, f.name))
                               for f in dataclasses.fields(secondary)}).to(self.device)

        if getattr(self, "_render_secondary_fn", None) is None:
            passes = ("cache", "light", "is_secondary")
            if self.vis_surface_light_field:
                passes = passes + ("surface_light_field_vis",)
            self._render_secondary_fn = train_lib.create_render_fn(self.model, passes=passes)
        return renderer.render_image(self._render_secondary_fn, flat, self.render_rng,
                                     self.config, height=light_h, width=light_w,
                                     train_frac=train_frac, device=self.device)

    def render_vmf(self, rendering, select_x, select_y):
        """The light sampler's vMF mixture at one pixel as an equirectangular
        sRGB image [h, w, 3], from a rendering with the "light_sampler_vis"
        pass; None where the rendering has none."""
        if "vmf_means" not in rendering:
            return None
        light_h, light_w = self._probe_resolution()
        _, _, light_xyz, _ = render_utils.get_sphere_directions(
            light_h, light_w, flip=self.config.flip_secondary)
        means = torch.as_tensor(np.asarray(rendering["vmf_means"])[select_y, select_x],
                                dtype=torch.float32)
        means = means / torch.clamp(torch.linalg.norm(means, dim=-1, keepdim=True), min=1e-5)
        kappas = torch.as_tensor(np.asarray(rendering["vmf_kappas"])[select_y, select_x, ..., 0],
                                 dtype=torch.float32)
        weights = torch.exp(torch.as_tensor(
            np.asarray(rendering["vmf_logits"])[select_y, select_x, ..., 0], dtype=torch.float32))
        weights = weights / weights.sum(-1, keepdim=True)
        density = torch.sum(weights * render_utils.eval_vmf(light_xyz[..., None, :], means,
                                                            kappas), dim=-1)
        density = density.reshape(light_h, light_w, 1)
        return image_lib.linear_to_srgb(density.repeat(1, 1, 3)).numpy()

    def _visualize_secondary(self, step, rendering, rays, train_frac):
        """The probe at the pixel 0.3 across and 0.6 down the view, and the
        vMF image there: their vis suites saved under ``secondary/`` and
        ``vmf/``. Returns the probe's rendering (None without the view's
        median distance or normals)."""
        if "distance_median" not in rendering:
            return None
        normals_key = "normals_to_use" if "normals_to_use" in rendering else "normals"
        if normals_key not in rendering:
            return None
        height, width = self.test_dataset.height, self.test_dataset.width
        select_x = int(np.round(width * 0.3))
        select_y = int(np.round(height * 0.6))
        secondary = self.render_secondary_rays(rays, rendering["distance_median"],
                                               rendering[normals_key], select_x, select_y,
                                               train_frac)
        if self.rank != 0:
            return secondary
        suite = vis_lib.visualize_transient_suite if self.use_transient else vis_lib.visualize_suite
        vis = suite(secondary, self.config)
        if self.save_dir and self.save_results:
            out_dir = os.path.join(self.save_dir, "secondary")
            os.makedirs(out_dir, exist_ok=True)
            vis_lib.save_vis_suite(vis, out_dir, step)
        vmf_img = self.render_vmf(rendering, select_x, select_y)
        if vmf_img is not None and self.save_dir and self.save_results:
            out_dir = os.path.join(self.save_dir, "vmf")
            os.makedirs(out_dir, exist_ok=True)
            vis_lib.save_img_u8(vmf_img, os.path.join(out_dir, f"{step:06d}.png"))
        return secondary

    def log_test_set_evaluation(self, step, train_frac):
        """Render one held-out view (every rank its share), score it and save
        its vis suite (rank 0); returns the metrics (empty on other ranks)."""
        cam_idx = step % self.test_dataset.num_images
        t0 = time.time()
        rendering, batch = self.render_test_view(cam_idx, train_frac)
        if self.rank != 0:
            if self.vis_secondary:
                self._visualize_secondary(step, rendering, batch.rays, train_frac)
            mesh_lib.barrier()
            return {}
        height, width = self.test_dataset.height, self.test_dataset.width
        metrics = self._compute_eval_metrics(rendering, batch, height, width)
        for k, v in metrics.items():
            if k in self.metric_list:
                self.metric_list[k].append(float(v))

        if self.save_dir and self.save_results:
            os.makedirs(self.save_dir, exist_ok=True)
            suite = (vis_lib.visualize_transient_suite if self.use_transient
                     else vis_lib.visualize_suite)
            vis = suite(rendering, self.config, vis_material=self.use_material)
            vis_lib.save_vis_suite(vis, self.save_dir, step)
            if "rgb" in rendering:
                d = os.path.join(self.save_dir, "color")
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, f"{step:06d}.npy"), rendering["rgb"])
            if self.use_transient and "cache_rgb" in rendering:
                self._save_transient_h5(rendering, step)
        if self.vis_secondary:
            self._visualize_secondary(step, rendering, batch.rays, train_frac)
        print(f"eval step={step} cam={cam_idx} "
              + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
              + f" ({time.time() - t0:.1f}s)", flush=True)
        mesh_lib.barrier()
        return metrics

    def _save_transient_h5(self, rendering, step):
        """The view's transient as `transients/<step>.h5` (dataset `data`,
        float32, NaNs zeroed) and one time slice of it."""
        d = os.path.join(self.save_dir, "transients")
        os.makedirs(d, exist_ok=True)
        transient = vis_lib.finite(rendering["cache_rgb"])
        hdf5.write_h5(os.path.join(d, f"{step:06d}.h5"), "data", transient)
        self._save_transient_time_slice(transient, step)

    def _save_transient_time_slice(self, transient, step):
        """One time-bin slice per eval view, scrubbing bins
        `Config.transient_start_idx` -> `transient_end_idx` over the
        sequence of views, under `cache_time_slice/<step>.png`."""
        if transient.ndim < 4:
            return
        n_bins = transient.shape[-2]
        total = max(self.test_dataset.num_images, 1)
        frac = (step % total) / float(total)
        t = self.config.transient_start_idx + frac * (
            min(self.config.transient_end_idx, n_bins - 1) - self.config.transient_start_idx)
        t0, t1 = int(np.floor(t)), min(int(np.ceil(t)), n_bins - 1)
        w = t - t0
        time_slice = transient[..., t0, :] * (1 - w) + transient[..., t1, :] * w
        d = os.path.join(self.save_dir, "cache_time_slice")
        os.makedirs(d, exist_ok=True)
        peak = float(np.max(time_slice) + 1e-12)
        vis_lib.save_img_u8(time_slice / peak, os.path.join(d, f"{step:06d}.png"))

    # --- train -----------------------------------------------------------------

    def train(self):
        if self.viewer_only:
            raise NotImplementedError("the interactive viewer is not ported")
        return self._train_impl()

    def _fetch_stats(self, stats_buffer):
        """(mean loss over the buffered steps, {loss name: value} of the last
        one), averaged over the ranks, read with one device-to-host copy."""
        names = list(stats_buffer[-1]["losses"])
        device = stats_buffer[-1]["loss"].device
        values = [s["loss"].reshape(()) for s in stats_buffer] + [
            torch.as_tensor(stats_buffer[-1]["losses"][k], device=device).float().mean()
            for k in names]
        host = mesh_lib.allreduce_mean(torch.stack([v.float() for v in values])).cpu().numpy()
        n = len(stats_buffer)
        return float(np.mean(host[:n])), dict(zip(names, host[n:].tolist()))

    def _train_impl(self):
        config = self.config
        num_steps = (config.early_exit_steps if config.early_exit_steps is not None
                     else self.max_steps)
        init_step = self.state.step // self.grad_accum_steps + 1
        if self.vis_only:
            self._run_visualization_only()
            return

        raybatcher = RayBatcher(self.dataset)
        stats_buffer = []
        t_start = time.time()
        log_path = (os.path.join(config.checkpoint_dir, "train_log.jsonl")
                    if config.checkpoint_dir and self.rank == 0 else None)
        profiler = None
        try:
            for step in range(init_step, num_steps + 1):
                if config.profile_dir and self.rank == 0:
                    if step == config.profile_start_step and profiler is None:
                        profiler = self._start_profile()
                    elif profiler is not None and step == (config.profile_start_step
                                                           + config.profile_num_steps):
                        self._stop_profile(profiler, step)
                        profiler = None
                train_frac = float(np.clip((step - 1) / max(1, self.max_steps - 1), 0, 1))
                for s in range(self.grad_accum_steps):
                    # With secondary accumulation one batch feeds several
                    # consecutive micro-steps (their secondary-ray draws).
                    if s % self.secondary_grad_accum_steps == 0:
                        batch = next(raybatcher)
                    with torch.profiler.record_function(
                            f"train step_num={step * self.grad_accum_steps + s}"):
                        self.state, stats = self.train_step(self.rng, self.state, batch,
                                                            train_frac)

                if step % config.gc_every == 0:
                    gc.collect()
                if step == 1 or step % config.checkpoint_every == 0:
                    self.save_checkpoint(step, blocking=False)

                stats_buffer.append(stats)
                if step == init_step or step % config.print_every == 0:
                    loss, last_losses = self._fetch_stats(stats_buffer)
                    dt = time.time() - t_start
                    rays_per_sec = (self.batch_size * len(stats_buffer) * self.grad_accum_steps
                                    / max(dt, 1e-6))
                    line = {"step": step, "loss": loss, "rays_per_sec": rays_per_sec,
                            "lr": float(self.lr_fn(step))}
                    line.update({f"loss/{k}": v for k, v in last_losses.items()})
                    if self.rank == 0:
                        print(f"step={step}/{num_steps} loss={loss:.5f} "
                              f"rays/sec={rays_per_sec:.0f}", flush=True)
                    if log_path:
                        with open(log_path, "a") as f:
                            f.write(json.dumps(line) + "\n")
                    stats_buffer = []
                    t_start = time.time()

                if (config.train_render_every > 0 and step % config.train_render_every == 0
                        and not config.no_vis):
                    self.log_test_set_evaluation(step, train_frac)
        finally:
            raybatcher.stop()
            if profiler is not None:
                self._stop_profile(profiler, num_steps + 1)
        self.save_checkpoint(num_steps)
        ckpt_lib.wait_for_pending_save()

    def _start_profile(self):
        """A torch.profiler trace of the host and, on the card, of its
        kernels, from here to `_stop_profile`."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, end_step):
        """End the trace (after the device's work) and write it as a Chrome
        trace `train_steps_<first>-<last>.json` into `Config.profile_dir`."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, f"train_steps_"
                            f"{self.config.profile_start_step}-{end_step - 1}.json")
        profiler.export_chrome_trace(path)
        print(f"profile: steps {self.config.profile_start_step}-{end_step - 1} traced to {path}",
              flush=True)
        return path

    def _compute_albedo_ratio(self, n_views):
        """Run-level albedo colour calibration over every 10th test view: the
        per-channel median of gt/pred, or a per-channel least-squares fit
        (in gamma space with ``albedo_gamma``). A test set without albedo
        images leaves the ratio None without a render (the JAX trainer
        renders its first view before it finds no albedo there)."""
        if self.test_dataset.albedo_images is None:
            return
        gts, preds = [], []
        for idx in range(self.vis_start, n_views, 10):
            rendering, batch = self.render_test_view(idx, 1.0)
            if batch.albedos is None or "material_albedo" not in rendering:
                return
            gt = _host(batch.albedos).reshape(-1, 3)
            pred = np.clip(np.asarray(rendering["material_albedo"]).reshape(-1, 3), 0.0,
                           self.albedo_clip)
            if batch.masks is not None:
                m = _host(batch.masks).reshape(-1, batch.masks.shape[-1])[..., 0] > 0.5
                gt, pred = gt[m], pred[m]
            gts.append(gt)
            preds.append(pred)
        if not gts:
            return
        gt = np.concatenate(gts, axis=0)
        pred = np.concatenate(preds, axis=0)
        if self.albedo_correct_median:
            ratio = np.median(gt / np.clip(pred, 1e-6, 1.0), axis=0)
        else:
            if self.albedo_gamma:
                gt, pred = gt ** (1 / 2.2), pred ** (1 / 2.2)
            ratio = (gt * pred).sum(axis=0) / np.maximum((pred**2).sum(axis=0), 1e-8)
            if self.albedo_gamma:
                ratio = ratio**2.2
        self.albedo_ratio = ratio.reshape(1, 3)
        if self.save_dir and self.rank == 0:
            np.save(os.path.join(self.save_dir, "albedo_ratio.npy"), self.albedo_ratio)

    def _run_visualization_only(self):
        """Render the test set and write the metrics to results.txt."""
        if self.save_dir and self.rank == 0:
            os.makedirs(self.save_dir, exist_ok=True)
        n_views = min(self.test_dataset.num_images, self.vis_end)
        if self.config.compute_albedo_metrics and self.albedo_ratio is None:
            self._compute_albedo_ratio(n_views)
        for idx in range(self.vis_start, n_views):
            self.log_test_set_evaluation(idx, 1.0)
        for k, v in self.metric_list.items():
            self.metric_list[k].append(sum(v) / len(v) if v else 0.0)
        if self.save_dir and self.rank == 0:
            with open(os.path.join(self.save_dir, "results.txt"), "w") as f:
                for key, values in self.metric_list.items():
                    f.write(f"{key}: {values}\n")
        mesh_lib.barrier()
