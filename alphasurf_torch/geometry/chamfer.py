"""Chamfer distance and point-cloud downsampling, the counterpart of the JAX
package's ``geometry.chamfer`` (svox2's opt/eval_cf_blender.py ``eval_cf``,
and train_eval.sh's ``--downsample``). Host code on numpy arrays: scipy's
``cKDTree`` for the nearest neighbours, as the JAX package uses."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def chamfer(pts: np.ndarray, gt_pts: np.ndarray) -> dict:
    """Mean nearest-neighbour distances both ways and their mean: d2s from
    the prediction to the ground truth, s2d back; inf when either is
    empty."""
    if len(pts) == 0 or len(gt_pts) == 0:
        return {"d2s": np.inf, "s2d": np.inf, "overall": np.inf}
    # workers=-1: the queries on every host core; the distances do not change
    d2s = cKDTree(gt_pts).query(pts, k=1, workers=-1)[0].mean()
    s2d = cKDTree(pts).query(gt_pts, k=1, workers=-1)[0].mean()
    return {"d2s": float(d2s), "s2d": float(s2d), "overall": float((d2s + s2d) / 2)}


def downsample_points(pts: np.ndarray, radius: float) -> np.ndarray:
    """The first point of each cubic cell of side ``radius``, in ascending
    order: the points the JAX package's ``voxel_downsample`` keeps
    (csrc/native.cpp), whose cell of a float32 point p is floor(p * (1 /
    radius)) in float64, packed 21 bits per axis."""
    if len(pts) == 0 or radius <= 0:
        return pts
    k = np.floor(np.asarray(pts, np.float32).astype(np.float64) * (1.0 / radius)).astype(np.int64)
    mask = (1 << 21) - 1
    key = ((((k[:, 0] + (1 << 20)) & mask) << 42) | (((k[:, 1] + (1 << 20)) & mask) << 21)
           | ((k[:, 2] + (1 << 20)) & mask))
    _, idx = np.unique(key, return_index=True)  # first occurrences (a stable sort)
    return pts[np.sort(idx)]
