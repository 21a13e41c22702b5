"""Render a dataset split's views from a checkpoint and report PSNR and
SSIM (and LPIPS when its weights exist), the counterpart of the JAX
package's ``app.render_imgs`` (svox2's opt/render_imgs.py): PNGs in
``render_{split}/`` beside the checkpoint and the mean metrics in
``test_psnr.txt`` (the autotune protocol, autotune.py:48-57).

Usage: python -m alphasurf_torch.app.render_imgs CKPT DATA_DIR [--split test]
           [--render_depth] [--no_imsave] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from os import path

import numpy as np


def main(argv=None) -> float:
    from ..app.config import Config, render_options_from
    from ..core.device import resolve_device
    from ..data import datasets
    from ..data.base import camera_of
    from ..render.image import render_image
    from ..utils.io import load_grid
    from ..utils.lpips import make_lpips
    from ..utils.metrics import compute_ssim, psnr
    from ..utils.png import write_png

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("data_dir")
    ap.add_argument("--dataset_type", default="auto")
    ap.add_argument("--split", default="test")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--scene_scale", type=float, default=None)
    ap.add_argument("--no_imsave", action="store_true")
    ap.add_argument("--n_images", type=int, default=None)
    ap.add_argument("--render_depth", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt_path = args.ckpt
    if path.isdir(ckpt_path):
        ckpt_path = path.join(ckpt_path, "ckpt.npz")
    grid, step = load_grid(ckpt_path, device=device)
    print(f"loaded {ckpt_path} (step {step}, reso {grid.reso}, capacity {grid.capacity})")

    dset = datasets[args.dataset_type](args.data_dir, split=args.split, scale=args.scale,
                                       scene_scale=args.scene_scale, device=device)
    cfg = Config(only_outward_intersect=True, truncated_vol_render=True, sigma_thresh=-1e9,
                 stop_thresh=1e-7)
    opt = render_options_from(cfg, no_surface=grid.surface_data is None)

    out_dir = path.join(path.dirname(ckpt_path), f"render_{args.split}")
    os.makedirs(out_dir, exist_ok=True)
    n = dset.n_images if args.n_images is None else min(args.n_images, dset.n_images)
    lpips_fn = make_lpips(device=device)  # None unless the weight files exist
    psnrs, ssims, lpipss = [], [], []
    for i in range(n):
        cam = camera_of(dset, i)
        if args.render_depth:
            img, depth = render_image(grid, cam, opt, return_depth=True, device=device)
        else:
            img = render_image(grid, cam, opt, device=device)
        gt = dset.gt[i]
        p, s = psnr(img, gt), compute_ssim(img, gt, device=device)
        psnrs.append(p)
        ssims.append(s)
        lp = lpips_fn(img, gt) if lpips_fn is not None else None
        if lp is not None:
            lpipss.append(lp)
        print(f"view {i}: psnr={p:.3f} ssim={s:.4f}"
              + (f" lpips={lp:.4f}" if lp is not None else ""))
        if not args.no_imsave:
            write_png(path.join(out_dir, f"{i:04d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            if args.render_depth:
                d = depth / max(depth.max(), 1e-9)
                write_png(path.join(out_dir, f"{i:04d}_depth.png"),
                          (np.clip(d, 0, 1) * 255).astype(np.uint8))

    stats = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "n": n}
    line = f"eval stats: psnr={stats['psnr']:.4f} ssim={stats['ssim']:.4f}"
    if lpipss:
        stats["lpips"] = float(np.mean(lpipss))
        line += f" lpips={stats['lpips']:.4f}"
    print(line)
    with open(path.join(path.dirname(ckpt_path), "test_psnr.txt"), "w") as f:
        json.dump(stats, f)
    return stats["psnr"]


if __name__ == "__main__":
    main()
