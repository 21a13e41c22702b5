"""The whole αSurf pipeline, svox2's train_eval.sh: the counterpart of the
JAX package's ``app.pipeline``. It chains five stages:

  1. Plenoxels (cuvol) training                       (opt.py, configs/plenoxels)
  2. αSurf surface training warm-started from (1)     (opt.py --load_pretrain_density_sh)
  3. test-view renders, PSNR and SSIM                 (render_imgs.py)
  4. iso-surface point extraction                     (app/extract_points.py, K9g)
  5. Chamfer evaluation against GT points             (app/eval_cf.py)

On the procedural synthetic dataset the test views go through the
Trainer's eval and the GT points are the analytic sphere of
``make_gt_grid``. Any other registered dataset (``nerf``, ``dtu``) is
loaded from ``data_dir`` whole, its test views go through
``app/render_imgs.py``, and the Chamfer stage runs only when
``gt_points_path`` is given, as in the JAX package.

Usage: python -m alphasurf_torch.app.pipeline --out_dir DIR [--reso 32]
           [--n_iters_plenoxels N] [--n_iters_surface N] ... [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time
from os import path

import numpy as np


def synthetic_gt_points(reso: int, n: int = 20000, seed: int = 0) -> np.ndarray:
    """Uniform samples of the synthetic GT sphere's surface (radius reso/4
    grid units = 0.5 world units, data/synthetic.make_gt_grid)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (0.5 * v).astype(np.float32)


def synthetic_datasets(data_dir: str, reso: int, n_train_images: int,
                       n_eval_images: int | None, image_size: int, device):
    """The synthetic train and test views (the test views: n_eval_images,
    or a quarter of the train views, at least 2)."""
    from ..data import datasets

    def make_dset(split):
        n = n_train_images if split == "train" else max(2, n_eval_images or n_train_images // 4)
        return datasets["synthetic"](data_dir, split=split, n_images=n, width=image_size,
                                     height=image_size, reso=reso, device=device)

    return make_dset("train"), make_dset("test")


def plenoxels_config(plen_dir: str, reso: int, batch_size: int, n_iters_plenoxels: int):
    """Stage 1's Config, train_eval.sh:28 (configs/plenoxels)."""
    from ..app.config import Config

    return Config(
        train_dir=plen_dir, reso=[[reso] * 3], surface_type="none",
        batch_size=batch_size, n_iters=n_iters_plenoxels,
        lr_sigma=3e1, lr_sigma_final=3e0, lr_sigma_delay_steps=0,
        lr_sh=1e-2, lr_sh_final=1e-2,
        lambda_tv=1e-6, lambda_tv_sh=1e-4,
        init_sigma=0.5, sigma_thresh=-1e9, stop_thresh=-1e9,
        eval_every_iter=0, print_every=max(50, n_iters_plenoxels // 8),
        save_every=-1, n_eval_test=2, nosphereinit=True, tune_mode=True,
    )


def surface_config(surf_dir: str, plen_dir: str, reso_surface: int, batch_size: int,
                   n_iters_surface: int):
    """Stage 2's Config, train_eval.sh:42: the surface warm-started from
    the Plenoxels checkpoint in ``plen_dir``."""
    from ..app.config import Config

    return Config(
        train_dir=surf_dir, reso=[[reso_surface] * 3], surface_type="sdf",
        batch_size=batch_size, n_iters=n_iters_surface,
        load_pretrain_density_sh=plen_dir,
        surf_init_density_lvs=[1.5], surf_init_alpha_rescale=1.0,
        lr_alpha=1e-1, lr_alpha_final=1e-2, lr_alpha_delay_steps=0,
        lr_surface=1e-2, lr_surface_final=1e-3, lr_surface_delay_steps=0,
        lr_sh_surf=1e-2, lr_sh_surf_final=1e-2,
        lambda_tv_alpha=1e-6, lambda_tv_surface=1e-5,
        lambda_normal_loss_l1=1e-6, no_surf_norm_con_check=True,
        lambda_l_entropy=1e-5,
        only_outward_intersect=True,
        surf_fake_sample=True, limited_fake_sample=True,
        fake_sample_std=0.2, fake_sample_std_final=0.05,
        fs_std_decay_type="linear",
        fake_sample_std_decay_steps=max(1, n_iters_surface // 2),
        truncated_vol_render=True,
        truncated_vol_render_a_final=0.5,
        truncated_vol_render_a_decay_steps=max(1, n_iters_surface // 2),
        sigma_thresh=-1e9, stop_thresh=-1e9,
        eval_every_iter=0, print_every=max(50, n_iters_surface // 8),
        save_every=-1, n_eval_test=2, nosphereinit=True, tune_mode=True,
    )


def run_pipeline(
    out_dir: str,
    data_dir: str = "",
    dataset_type: str = "synthetic",
    reso: int = 32,
    reso_surface: int | None = None,
    n_train_images: int = 30,
    image_size: int = 64,
    n_iters_plenoxels: int = 800,
    n_iters_surface: int = 800,
    batch_size: int = 2000,
    gt_points_path: str | None = None,
    eval_downsample: float = 0.0,
    overrides_plenoxels: dict | None = None,
    overrides_surface: dict | None = None,
    n_eval_images: int | None = None,
    device="cuda",
) -> dict:
    """Run the five stages on ``device``; returns the result dict (PSNR,
    Chamfer, seconds and rays/s per stage) and writes it to
    out_dir/pipeline_results.json. ``n_train_images``, ``image_size`` and
    ``n_eval_images`` size the synthetic dataset only."""
    from ..app import eval_cf, extract_points, render_imgs
    from ..core.device import resolve_device
    from ..data import datasets
    from ..train.trainer import Trainer

    device = resolve_device(device)
    reso_surface = reso_surface or reso
    t_all = time.time()
    results = {"stages": {}}

    if dataset_type == "synthetic":
        dset_train, dset_test = synthetic_datasets(data_dir, reso, n_train_images,
                                                   n_eval_images, image_size, device)
    else:
        dset_train, dset_test = (datasets[dataset_type](data_dir, split=split, device=device)
                                 for split in ("train", "test"))

    # ---- stage 1: Plenoxels warm start (train_eval.sh:28) ----
    plen_dir = path.join(out_dir, "plenoxels")
    cfg1 = plenoxels_config(plen_dir, reso, batch_size, n_iters_plenoxels)
    for k, v in (overrides_plenoxels or {}).items():
        setattr(cfg1, k, v)
    t0 = time.time()
    tr1 = Trainer(cfg1, dset_train, dset_test, device=device)
    psnr_plen = tr1.train()
    results["stages"]["plenoxels"] = {
        "psnr": psnr_plen, "seconds": time.time() - t0,
        "rays_per_s": n_iters_plenoxels * batch_size / (time.time() - t0),
    }

    # ---- stage 2: αSurf surface refinement (train_eval.sh:42) ----
    surf_dir = path.join(out_dir, "surface")
    cfg2 = surface_config(surf_dir, plen_dir, reso_surface, batch_size, n_iters_surface)
    for k, v in (overrides_surface or {}).items():
        setattr(cfg2, k, v)
    t0 = time.time()
    tr2 = Trainer(cfg2, dset_train, dset_test, device=device)
    psnr_surf_train = tr2.train()
    results["stages"]["surface"] = {
        "psnr": psnr_surf_train, "seconds": time.time() - t0,
        "rays_per_s": n_iters_surface * batch_size / (time.time() - t0),
        "capacity": int(tr2.grid.capacity),
    }

    # ---- stage 3: test renders and PSNR (train_eval.sh:46-48): the
    # synthetic data through the Trainer's eval, as the JAX pipeline does ----
    t0 = time.time()
    if dataset_type == "synthetic":
        psnr_test = tr2.eval_step(final=True)
    else:
        psnr_test = render_imgs.main([path.join(surf_dir, "ckpt.npz"), data_dir,
                                      "--dataset_type", dataset_type, "--no_imsave",
                                      "--device", str(device)])
    results["stages"]["render"] = {"psnr": psnr_test, "seconds": time.time() - t0}

    # ---- stage 4: point extraction (train_eval.sh:60-61) ----
    t0 = time.time()
    pts = extract_points.main([
        path.join(surf_dir, "ckpt.npz"),
        "--intersect_th", "0.1", "--n_sample", "5",
        "--out", path.join(out_dir, "pts.npy"), "--device", str(device),
    ])
    results["stages"]["extract"] = {"n_points": int(len(pts)), "seconds": time.time() - t0}

    # ---- stage 5: Chamfer (train_eval.sh:63) ----
    if gt_points_path is None and dataset_type == "synthetic":
        gt_points_path = path.join(out_dir, "gt_pts.npy")
        np.save(gt_points_path, synthetic_gt_points(reso))
    if gt_points_path:
        t0 = time.time()
        argv = [path.join(out_dir, "pts.npy"), gt_points_path]
        if eval_downsample > 0:
            argv += ["--downsample", str(eval_downsample)]
        results["stages"]["chamfer"] = dict(eval_cf.main(argv), seconds=time.time() - t0)

    results["total_seconds"] = time.time() - t_all
    results["summary"] = {
        "psnr": psnr_test,
        "chamfer": results["stages"].get("chamfer", {}).get("overall"),
        "rays_per_s_train": results["stages"]["surface"]["rays_per_s"],
    }
    with open(path.join(out_dir, "pipeline_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("pipeline results:", json.dumps(results["summary"]))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--dataset_type", default="synthetic")
    ap.add_argument("--reso", type=int, default=32)
    ap.add_argument("--reso_surface", type=int, default=None)
    ap.add_argument("--n_train_images", type=int, default=30)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--n_iters_plenoxels", type=int, default=800)
    ap.add_argument("--n_iters_surface", type=int, default=800)
    ap.add_argument("--batch_size", type=int, default=2000)
    ap.add_argument("--gt_points", default=None)
    ap.add_argument("--eval_downsample", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run_pipeline(
        args.out_dir, data_dir=args.data_dir, dataset_type=args.dataset_type,
        reso=args.reso, reso_surface=args.reso_surface,
        n_train_images=args.n_train_images, image_size=args.image_size,
        n_iters_plenoxels=args.n_iters_plenoxels,
        n_iters_surface=args.n_iters_surface, batch_size=args.batch_size,
        gt_points_path=args.gt_points, eval_downsample=args.eval_downsample,
        device=args.device,
    )


if __name__ == "__main__":
    main()
