"""The recipe-scale three-stage run on the procedural synthetic scene, the
counterpart of the JAX package's ``tools/recipe_run.py`` (train_eval.sh's
pipeline: Plenoxels cuvol warm start, init_surface_from_density, the
αSurf surface stages with an upsample between them).

    python -m alphasurf_torch.app.recipe_run OUT_DIR [--width 800] [--n_images 25]
        [--reso 256 256 512] [--steps 600 600 1800] [--batch 8192] [--seed S] [--device cuda]

The configuration is tools/recipe_run.py's, key for key (its deviations from
surface_cuda_syn.yaml: batch 8192, the alpha-threshold upsample without
camera sweeps or visibility pruning, the two-pass cache losses off, the
synthetic sphere scene whose analytic surface is the Chamfer GT), and so are
the dataset (``SyntheticDataset(renderer="packed")``, ``n_images`` train
and 3 test views, ground truth from ``make_gt_grid(gt_reso)``) and the GT
points (20,000 points of the sphere of radius 0.5 over the extractor's scene
scale 2/3, numpy seed 0). The reference's mini run (BASELINE.md, round 5)
is ``--width 400 --n_images 9 --reso 64 64 128 --steps 150 150 300``.
``--seed`` sets the Config's seed (the batch order and the regularizer
windows; default the Config's), so that repeated runs show the spread.
Prints one ``RECIPE RESULT`` JSON line with the final eval's PSNR, SSIM and
Chamfer (cf_mean, d2s, s2d) and the wall time, and writes it to
OUT_DIR/result.json.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np


def recipe_config(out_dir: str, reso: list[int], steps: list[int], batch: int,
                  seed: int | None = None):
    """tools/recipe_run.py's Config (recipe_run.py:88-160)."""
    from .config import Config

    n_cuvol, n_surf1, n_surf2 = steps
    if n_surf1 != n_cuvol:
        raise ValueError("the upsamples fire at k * upsamp_every = k * n_cuvol")
    n_total, ns = sum(steps), n_surf1 + n_surf2
    return Config(
        train_dir=os.path.join(out_dir, "ckpt"), data_dir=os.path.join(out_dir, "data"),
        reso=[[r] * 3 for r in reso], surface_type="sdf", batch_size=batch, n_iters=n_total,
        no_surface_init_iters=n_cuvol, upsamp_every=n_cuvol, density_thresh=1.0,
        surf_init_density_lvs=[2.0, 6.0], surf_init_alpha_rescale=0.005,
        visibility_pruning_scale=0.0, thresh_type="alpha", alpha_upsample_thresh=1e-8,
        max_grid_elements=6_000_000, init_sigma=0.1,
        lr_sigma=3e1, lr_sigma_final=5e-2, lr_sigma_delay_steps=0, lr_sigma_decay_steps=n_total,
        lr_sh=1e-2, lr_sh_final=5e-6, lr_sh_decay_steps=n_total * 5,
        lambda_tv=1e-5, lambda_tv_sh=1e-3,
        lr_alpha=1e-2, lr_alpha_final=1e-3, lr_alpha_delay_steps=n_cuvol + ns // 2,
        lr_alpha_delay_mult=1e-2, lr_alpha_decay_steps=n_cuvol + ns,
        lr_surface=1e-5, lr_surface_final=1e-5, lr_surface_delay_steps=n_cuvol + ns // 2,
        lr_surface_delay_mult=1e-2, lr_surface_decay_steps=n_cuvol + ns,
        lr_sh_surf=1e-3, lr_sh_surf_final=1e-3, lr_sh_surf_delay_steps=0,
        lr_sh_surf_decay_steps=n_cuvol + ns,
        lambda_tv_alpha=1e-5, lambda_tv_surface=1e-3,
        tv_surface_sparsity=1.0, norm_surface_sparsity=1.0,
        surf_normal_loss_lambda_type="const", lambda_normal_loss=1e-6, surf_norm_reg_l1=True,
        no_surf_norm_con_check=True,
        lambda_sparsify_alpha=1e-9, lambda_sparsify_surf=0.0, sparsify_surf_decrease=True,
        sparsify_surf_thresh=0.15, alpha_surf_sparsify_sparsity=0.05,
        delay_sparsify_surf=n_cuvol + ns // 2,
        lambda_l_entropy=1e-4, lambda_conv_mode_samp=0.0,
        only_outward_intersect=True, surf_fake_sample=False, limited_fake_sample=True,
        truncated_vol_render=True, trunc_vol_render_lv_remove=True, trunc_vol_weight_min=1e-10,
        fs_std_decay_type="linear", fake_sample_std=0.1, fake_sample_std_final=1e-6,
        fake_sample_std_decay_steps=n_cuvol + ns, fake_sample_std_delay=n_cuvol,
        trunc_vol_a_decay_type="linear", truncated_vol_render_a=5.0,
        truncated_vol_render_a_final=1.0, truncated_vol_render_a_decay_steps=n_cuvol + ns // 2,
        truncated_vol_render_a_delay=n_cuvol,
        sigma_thresh=-10000.0, stop_thresh=-10000.0,
        eval_every_iter=0, print_every=100, save_every=-1, n_eval_test=3,
        final_render_eval=False, log_pts=True, eval_cf=True, surf_eval_n_sample=3,
        surf_eval_intersect_th=0.1, entries_per_ray=8.0, entries_per_ray_max=512.0,
        tune_mode=True, nosphereinit=False, **({} if seed is None else {"seed": seed}),
    )


def run(out_dir: str, width: int = 800, n_images: int = 25, gt_reso: int = 128,
        reso=(256, 256, 512), steps=(600, 600, 1800), batch: int = 8192,
        seed: int | None = None, device="cuda") -> dict:
    import torch

    from ..core.device import resolve_device
    from ..data.synthetic import SyntheticDataset
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg = recipe_config(out_dir, list(reso), list(steps), batch, seed)
    os.makedirs(cfg.data_dir, exist_ok=True)
    d = np.random.default_rng(0).normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.save(os.path.join(cfg.data_dir, "shape.npy"), (d * 0.5 / (2.0 / 3.0)).astype(np.float32))

    t0 = time.time()
    dset = SyntheticDataset(split="train", n_images=n_images, width=width, height=width,
                            reso=gt_reso, renderer="packed", device=dev)
    dset_test = SyntheticDataset(split="test", n_images=3, width=width, height=width,
                                 reso=gt_reso, renderer="packed", device=dev)
    setup = time.time() - t0
    print(f"dataset {setup:.1f}s ({n_images}x{width}x{width} train rays on {dev})", flush=True)
    tr = Trainer(cfg, dset, dset_test, device=dev)
    t0 = time.time()
    psnr = tr.train()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    last = [ln for ln in tr.log_lines if ln.startswith("eval stats:")][-1]
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([-\d.eE+]+)", last)}
    result = {
        "psnr": psnr, "ssim": stats["ssim"], "cf_mean": stats.get("cf_mean"),
        "cf_d2s": stats.get("cf_d2s"), "cf_s2d": stats.get("cf_s2d"),
        "wall_s": wall, "dataset_s": setup, "rays_per_s_avg": sum(steps) * batch / wall,
        "stages": list(steps), "batch": batch, "reso": list(reso), "width": width,
        "n_images": n_images, "seed": cfg.seed, "capacity_final": int(tr.grid.capacity),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print("RECIPE RESULT " + json.dumps(result), flush=True)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--n_images", type=int, default=25)
    ap.add_argument("--gt_reso", type=int, default=128)
    ap.add_argument("--reso", type=int, nargs=3, default=[256, 256, 512])
    ap.add_argument("--steps", type=int, nargs=3, default=[600, 600, 1800])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.out_dir, a.width, a.n_images, a.gt_reso, a.reso, a.steps, a.batch, a.seed,
               a.device)


if __name__ == "__main__":
    main()
