"""Point-cloud output of the evaluation, from the JAX package's
``geometry.dtu_eval``: only ``write_ply_points``, which the Trainer's
in-training extraction writes. The DTU evaluation itself waits for the
DTU loader (ROADMAP §1 item 6)."""
from __future__ import annotations

import numpy as np


def write_ply_points(path, points, colors=None) -> None:
    """ASCII PLY point cloud (svox2's eval_dtu.py:28-31), with optional
    (N, 3) colours in [0, 1]."""
    points = np.asarray(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            c8 = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, c8):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
