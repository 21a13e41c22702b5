"""Evaluate a checkpoint on test views: PSNR, SSIM and frames, the
counterpart of the JAX package's ``app.eval_imgs`` (svox2's
opt/eval_imgs.py). Renders ``--num_views`` test cameras (evenly spaced
when fewer than the split), writes ``test_renders[_trunc]/NNNN.png`` and
``psnr.txt`` / ``ssim.txt`` beside the checkpoint (``psnr_truc.txt`` /
``ssim_truc.txt`` with ``--truncated_vol_render``, which also sets
truncated_vol_render_a to 2, eval_imgs.py:114-117). ``--render_depth``
writes the median depth through the viridis colour map instead. No video
is written (the JAX package writes one only when imageio-ffmpeg is
present), so its ``--fps`` and ``--no_vid`` are not taken, nor its
``--depth_thresh``: the depth is always the median depth.

Usage: python -m alphasurf_torch.app.eval_imgs CKPT DATA_DIR [--num_views N]
           [--render_depth] [--truncated_vol_render] [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import os
from os import path

import numpy as np


def main(argv=None):
    import torch

    from ..app.config import Config, render_options_from
    from ..core.device import resolve_device
    from ..core.rays import Camera
    from ..data import datasets
    from ..render.image import render_image
    from ..utils.io import load_grid
    from ..utils.metrics import compute_ssim, viridis_cmap
    from ..utils.png import write_png

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("data_dir")
    ap.add_argument("--dataset_type", default="auto")
    ap.add_argument("--num_views", "-N", type=int, default=100000)
    ap.add_argument("--crop", type=float, default=1.0, help="Crop (0, 1], 1.0 = full image")
    ap.add_argument("--width", "-W", type=int, default=None)
    ap.add_argument("--height", "-H", type=int, default=None)
    ap.add_argument("--render_depth", action="store_true")
    ap.add_argument("--truncated_vol_render", action="store_true")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt_path = args.ckpt
    if path.isdir(ckpt_path):
        ckpt_path = path.join(ckpt_path, "ckpt.npz")
    grid, step = load_grid(ckpt_path, device=device)
    dset = datasets[args.dataset_type](args.data_dir, split="test", scale=args.scale,
                                       device=device)
    cfg = Config(only_outward_intersect=True, truncated_vol_render=args.truncated_vol_render,
                 sigma_thresh=-1e9, stop_thresh=1e-7)
    opt = render_options_from(cfg, no_surface=grid.surface_data is None)
    if args.truncated_vol_render:
        grid = grid.replace(truncated_vol_render_a=torch.tensor(
            2.0, dtype=grid.density_data.dtype, device=device))

    exp_dir = path.dirname(ckpt_path)
    img_out = path.join(exp_dir, "test_renders" + ("_trunc" if args.truncated_vol_render else ""))
    os.makedirs(img_out, exist_ok=True)
    n_total = dset.n_images
    if args.num_views >= n_total:
        ids = np.arange(n_total)
    else:
        ids = np.round(np.linspace(0, n_total - 1, args.num_views)).astype(int)
        print(f"Using test views with ids: {ids}")

    fx = np.atleast_1d(np.asarray(dset.intrins_full.fx))
    fy = np.atleast_1d(np.asarray(dset.intrins_full.fy))
    psnrs, ssims = [], []
    for k, i in enumerate(ids):
        H = args.height or dset.h_full
        W = args.width or dset.w_full
        if args.crop != 1.0:
            H, W = int(H * args.crop), int(W * args.crop)
        j = min(int(i), len(fx) - 1)
        cam = Camera.make(dset.c2w[int(i)], fx=fx[j], fy=fy[j], cx=W * 0.5, cy=H * 0.5, width=W,
                          height=H)
        if args.render_depth:
            im, depth = render_image(grid, cam, opt, return_depth=True, device=device)
            frame = viridis_cmap(depth)
        else:
            im = render_image(grid, cam, opt, device=device)
            frame = np.clip(im, 0.0, 1.0)
        gt = np.asarray(dset.gt[int(i)], np.float32)
        if gt.shape[:2] == im.shape[:2]:
            mse = float(np.mean((gt - im) ** 2))
            psnrs.append(-10.0 * math.log10(max(mse, 1e-12)))
            ssims.append(float(compute_ssim(im, gt)))
        write_png(path.join(img_out, f"{k:04d}.png"), (frame * 255).astype(np.uint8))

    if psnrs:
        all_psnr, all_ssim = float(np.mean(psnrs)), float(np.mean(ssims))
        print("PSNR:", psnrs)
        print("SSIM:", ssims)
        tag = "_truc" if args.truncated_vol_render else ""
        with open(path.join(exp_dir, f"psnr{tag}.txt"), "w") as f:
            f.write(str(all_psnr))
        with open(path.join(exp_dir, f"ssim{tag}.txt"), "w") as f:
            f.write(str(all_ssim))
        print(f"mean PSNR {all_psnr:.3f} SSIM {all_ssim:.4f}")
    return psnrs, ssims


if __name__ == "__main__":
    main()
