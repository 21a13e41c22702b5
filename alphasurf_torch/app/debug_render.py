"""Debug-render one test view of a checkpoint, or probe pixels of it, the
counterpart of the JAX package's ``app.debug_render`` (svox2's
opt/debug_render.py): loads ``TRAIN_DIR/ckpt.npz``, renders test view
``--img_id`` with fake samples forced off (debug_render.py:127) into
``debug_{step}.png`` beside the checkpoint; with ``--pixel X,Y`` it
renders only those pixels and prints each one's rgb, depth, alpha and
intersection count (the kernel's ``debug_pixels`` dump), and returns them.

Usage: python -m alphasurf_torch.app.debug_render TRAIN_DIR DATA_DIR
           [--img_id 46] [--pixel 167,315 ...] [--device cuda]
"""
from __future__ import annotations

import argparse
from os import path

import numpy as np


def main(argv=None):
    from ..app.config import Config, render_options_from
    from ..core.device import resolve_device
    from ..core.rays import Rays
    from ..data import datasets
    from ..data.base import camera_of
    from ..render.image import render_image
    from ..render.surface import volume_render_surface_packed
    from ..utils.io import load_grid
    from ..utils.png import write_png

    ap = argparse.ArgumentParser()
    ap.add_argument("train_dir")
    ap.add_argument("data_dir")
    ap.add_argument("--dataset_type", default="auto")
    ap.add_argument("--img_id", type=int, default=46)
    ap.add_argument("--pixel", action="append", default=[],
                    help="X,Y matplotlib coords (reference P_COORD)")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt = args.train_dir
    if path.isdir(ckpt):
        ckpt = path.join(ckpt, "ckpt.npz")
    if not path.isfile(ckpt):
        raise FileNotFoundError(f"Ckpt {ckpt} not found")
    grid, step = load_grid(ckpt, device=device)
    dset = datasets[args.dataset_type](args.data_dir, split="test", scale=args.scale,
                                       device=device)
    img_id = min(args.img_id, dset.n_images - 1)
    cfg = Config(only_outward_intersect=True, truncated_vol_render=True, sigma_thresh=-1e9,
                 stop_thresh=1e-7, surf_fake_sample=False)  # debug_render.py:127
    opt = render_options_from(cfg, no_surface=grid.surface_data is None)
    cam = camera_of(dset, img_id)

    if args.pixel and grid.surface_data is not None:
        rays = cam.gen_rays(device)
        probes = []
        for p in args.pixel:
            x, y = (int(v) for v in p.split(","))
            idx = y * cam.width + x  # the reference's rgb[P_y, P_x]
            out = volume_render_surface_packed(
                grid, Rays(rays.origins[idx:idx + 1], rays.dirs[idx:idx + 1]), opt)
            probe = {"pixel": (x, y), "rgb": out["rgb"][0].cpu().numpy(),
                     "depth": float(out["depth"][0]), "alpha": float(out["alpha"][0]),
                     "n_intersections": int(out["n_intersections"][0])}
            probes.append(probe)
            print(f"pixel ({x},{y}): rgb={probe['rgb']} depth={probe['depth']:.4f} "
                  f"alpha={probe['alpha']:.4f} n_intersections={probe['n_intersections']}")
        return probes

    im = np.clip(render_image(grid, cam, opt, device=device), 0.0, 1.0)
    out_png = path.join(path.dirname(ckpt), f"debug_{step}.png")
    write_png(out_png, (im * 255).astype(np.uint8))
    print("wrote", out_png)
    return out_png


if __name__ == "__main__":
    main()
