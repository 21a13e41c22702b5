"""Merge extracted point clouds and downsample the union, the counterpart of
the JAX package's ``app.combine_points`` (svox2's opt/combine_surf.py).
Host code on numpy arrays: it takes no device.

Usage: python -m alphasurf_torch.app.combine_points a.npy b.npy ...
           [--downsample_density 0.001] [--out combined.npy]
"""
from __future__ import annotations

import argparse

import numpy as np


def combine(point_sets, downsample_density: float = 0.001) -> np.ndarray:
    pts = np.concatenate([np.asarray(p, np.float32) for p in point_sets], 0)
    if downsample_density <= 0 or len(pts) == 0:
        return pts
    from ..geometry.chamfer import downsample_points

    return downsample_points(pts, downsample_density)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--downsample_density", type=float, default=0.001)
    ap.add_argument("--out", default="combined_pts.npy")
    args = ap.parse_args(argv)

    sets = [np.load(p) for p in args.inputs]
    print("input sizes:", [len(s) for s in sets])
    pts = combine(sets, args.downsample_density)
    np.save(args.out, pts)
    print(f"wrote {args.out} ({len(pts)} points)")
    return pts


if __name__ == "__main__":
    main()
