"""Extract the iso-surface point cloud of a checkpoint, the counterpart of
the JAX package's ``app.extract_points`` (svox2's exract_points_no_cam.py),
on K9g. The mesh (``--mesh``) is not ported yet (ROADMAP §1 item 8).

Usage: python -m alphasurf_torch.app.extract_points CKPT [--out pts.npy] [--device cuda]
"""
from __future__ import annotations

import argparse
from os import path

import numpy as np


def save_ply(pts: np.ndarray, out: str) -> None:
    with open(out, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def main(argv=None) -> np.ndarray:
    from ..geometry.chamfer import downsample_points
    from ..geometry.extract import extract_iso_points
    from ..utils.io import load_grid

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--out", default=None)
    ap.add_argument("--n_sample", type=int, default=5)
    ap.add_argument("--intersect_th", type=float, default=0.1,
                    help="alpha threshold for keeping points (train_eval.sh --intersect_th)")
    ap.add_argument("--downsample", type=float, default=0.0)
    ap.add_argument("--scene_scale", type=float, default=1.0)
    ap.add_argument("--mesh", default=None, help="also write an OBJ mesh (not ported yet)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: the marching-tetrahedra mesh is not ported yet "
                                  "(ROADMAP §1 item 8)")

    ckpt_path = args.ckpt
    if path.isdir(ckpt_path):
        ckpt_path = path.join(ckpt_path, "ckpt.npz")
    grid, step = load_grid(ckpt_path, device=args.device)
    print(f"loaded {ckpt_path} (step {step})")

    # alpha threshold in raw space: alpha = 1 - exp(-relu(raw)) >= th
    raw_th = -np.log(max(1.0 - args.intersect_th, 1e-9))
    pts = extract_iso_points(grid, n_sample=args.n_sample, density_thresh=raw_th,
                             scene_scale=args.scene_scale)
    print(f"extracted {len(pts)} points")
    if args.downsample > 0:
        pts = downsample_points(pts, args.downsample)
        print(f"downsampled to {len(pts)}")

    out = args.out or path.join(path.dirname(ckpt_path), "pts.npy")
    if out.endswith(".ply"):
        save_ply(pts, out)
    else:
        np.save(out, pts)
    print(f"wrote {out}")
    return pts


if __name__ == "__main__":
    main()
