"""Offline metrics over two directories of saved renders (counterpart of
``evaluation/run_evaluation.py``): PSNR, SSIM, LPIPS and, with
``--elpips_samples N``, E-LPIPS between each ground-truth image and the
prediction of the same sorted position (``.npy`` files, else PNGs), one line
per image and then one JSON line of the means.

    python -m neural_radiance_caching_tpu_torch.evaluation.run_evaluation \\
        --gt_dir SAVE/color_gt --pred_dir SAVE/color [--lpips_weights FILE] \\
        [--elpips_samples N] [--out FILE] [--device cpu]

LPIPS uses the calibrated VGG weights where ``ops/lpips.find_weights`` finds
a file (``--lpips_weights``, ``NRC_LPIPS_WEIGHTS``, the user cache, the
repository's ``weights/``), else the uncalibrated fallback network, and the
JSON says which (``lpips_calibrated``). LPIPS and E-LPIPS run on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * np.log(mse)


def compute_psnr(image0, image1):
    return float(mse_to_psnr(((image0 - image1) ** 2).mean()))


def compute_ssim(image0, image1):
    from neural_radiance_caching_tpu_torch.ops import image as image_lib

    return float(image_lib.ssim(image0, image1))


def load_image(path):
    """An [H, W, 3] float32 image in [0, 1] (NaNs zeroed): a .npy array,
    else a PNG divided by 255."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from neural_radiance_caching_tpu_torch.data import io as io_lib

        img = io_lib.load_img(path) / 255.0
    return np.clip(np.nan_to_num(img[..., :3].astype(np.float32)), 0.0, 1.0)


def get_files(gt_dir, pred_dir):
    def files(d):
        out = sorted(glob.glob(os.path.join(d, "*.npy")))
        return out or sorted(glob.glob(os.path.join(d, "*.png")))

    gt_files, pred_files = files(gt_dir), files(pred_dir)
    if len(gt_files) != len(pred_files):
        raise ValueError(f"count mismatch: {len(gt_files)} gt vs {len(pred_files)} pred")
    return gt_files, pred_files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--pred_dir", required=True)
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--elpips_samples", type=int, default=0,
                        help="if >0, also compute E-LPIPS with this many ensemble samples")
    parser.add_argument("--out", default=None, help="optional JSON output path")
    parser.add_argument("--device", default="cuda",
                        help="where LPIPS runs: the card unless 'cpu' is given")
    args = parser.parse_args(argv)

    from neural_radiance_caching_tpu_torch.ops import lpips as lpips_lib
    from neural_radiance_caching_tpu_torch.utils import torchutil, weights

    torchutil.check_device(args.device, "LPIPS", "run_evaluation (--device cpu)")
    host_params = lpips_lib.default_params(args.lpips_weights)
    calibrated = bool(host_params["calibrated"])
    if not calibrated:
        print("LPIPS: no calibrated weights found — scoring with the deterministic "
              "UNCALIBRATED fallback (untrained VGG; see ops/lpips.py). Values are "
              "self-consistent, not comparable to published tables.")
    params = weights.lpips_params_to_torch(host_params, args.device)

    gt_files, pred_files = get_files(args.gt_dir, args.pred_dir)
    psnrs, ssims, lpipss, elpipss = [], [], [], []
    for gt_f, pred_f in zip(gt_files, pred_files):
        gt, pred = load_image(gt_f), load_image(pred_f)
        psnrs.append(compute_psnr(pred, gt))
        ssims.append(compute_ssim(pred, gt))
        line = f"{os.path.basename(pred_f)}: psnr={psnrs[-1]:.3f} ssim={ssims[-1]:.4f}"
        lpipss.append(float(lpips_lib.lpips(params, pred, gt, device=args.device)))
        line += f" lpips={lpipss[-1]:.4f}"
        if args.elpips_samples > 0:
            elpipss.append(lpips_lib.elpips(params, pred, gt, num_samples=args.elpips_samples,
                                            device=args.device))
            line += f" elpips={elpipss[-1]:.4f}"
        print(line)

    result = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "lpips_calibrated": calibrated,
        "elpips": float(np.mean(elpipss)) if elpipss else None,
        "count": len(psnrs),
    }
    if elpipss:
        result["elpips_caveat"] = (
            "fast_and_approximate ensemble: crop-mode transforms, "
            "keep_prob=0.99 network dropout (see ops/lpips.py)")
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
