"""Chamfer evaluation of a point cloud against ground-truth points, the
counterpart of the JAX package's ``app.eval_cf`` (svox2's
opt/eval_cf_blender.py). Host code on numpy arrays: it takes no device.

Usage: python -m alphasurf_torch.app.eval_cf PTS GT [--downsample r]
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_pts(p: str) -> np.ndarray:
    """(N, 3) float32 points of a .ply (ASCII) or .npy file."""
    if p.endswith(".ply"):
        pts = []
        with open(p) as f:
            n = 0
            for line in f:
                if line.startswith("element vertex"):
                    n = int(line.split()[-1])
                if line.strip() == "end_header":
                    break
            for _ in range(n):
                pts.append([float(x) for x in f.readline().split()[:3]])
        return np.asarray(pts, np.float32)
    return np.load(p).astype(np.float32).reshape(-1, 3)


def main(argv=None) -> dict:
    from ..geometry.chamfer import chamfer, downsample_points

    ap = argparse.ArgumentParser()
    ap.add_argument("pts", help=".npy/.ply point cloud (prediction)")
    ap.add_argument("gt_path", help="GT points: shape.npy or .npy point cloud")
    ap.add_argument("--downsample", type=float, default=0.0)
    args = ap.parse_args(argv)

    pts = load_pts(args.pts)
    gt = load_pts(args.gt_path)
    if args.downsample > 0:
        pts = downsample_points(pts, args.downsample)
        gt = downsample_points(gt, args.downsample)
    res = chamfer(pts, gt)
    print("eval stats: " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
