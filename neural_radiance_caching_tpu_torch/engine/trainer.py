"""Eval of one held-out view (counterpart of ``Trainer.render_test_view``
and ``Trainer._compute_eval_metrics`` in ``engine/trainer.py``).

Two module-level functions for now; the ``Trainer`` class is not ported yet
(ROADMAP queue 1 item 4), so what the JAX methods read from the trainer
(the test dataset, the render function, the metric harness, the
postprocess function, the albedo calibration) is passed in. The metrics
run on host numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.engine import renderer
from neural_radiance_caching_tpu_torch.utils import pytrees


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def render_test_view(render_fn, dataset, cam_idx, rng, config, train_frac=1.0):
    """Render one view of `dataset` (all its pixels, ``config.render_repeats``
    draws each); returns (rendering dict of [H, W, ...] host arrays, the
    view's batch)."""
    batch = dataset.generate_ray_batch(cam_idx)
    if isinstance(batch.rays, pytrees.Pixels):
        raise NotImplementedError("eval ray casting from Pixels is not ported yet")
    rendering = renderer.render_image(
        render_fn, batch.rays, rng, config, height=dataset.height, width=dataset.width,
        train_frac=train_frac, render_repeats=config.render_repeats, device=dataset.device)
    return rendering, batch


def compute_eval_metrics(rendering, batch, height, width, config, metric_harness, postprocess_fn,
                         albedo_ratio=None, albedo_clip=1.0):
    """PSNR and SSIM, the normal mean angular error, the depth L1 (median and
    mean), the albedo PSNR and the transient IoU of one rendered view.

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
        pred_t = np.nan_to_num(np.asarray(rendering["cache_rgb"]))
        gt_t = gt[..., :3]
        if pred_t.shape == gt_t.shape:
            inter = np.minimum(pred_t, gt_t).sum()
            union = np.maximum(pred_t, gt_t).sum()
            metrics["transient_iou"] = float(inter / max(union, 1e-12))
    return metrics
