"""Checkpoint I/O, the counterpart of the JAX package's ``utils.io``: the same
npz keys (svox2's ``SparseGrid.save``/``load``, svox2.py:4693-4838), SH
stored as float16, the learned bases as ``basis_data`` and
``basis_mlp.{w0,b0,w1,b1}``, and the flat-order renumbering of data rows on
load, so a checkpoint written by either package loads in both."""
from __future__ import annotations

import numpy as np
import torch

from .. import defs
from ..core.device import resolve_device
from ..core.grid import SparseGrid


def save_grid(grid: SparseGrid, path: str, step_id: int = 0) -> None:
    a = grid.to_numpy()
    data = {
        "radius": np.asarray(a["radius"], np.float32),
        "center": np.asarray(a["center"], np.float32),
        "links": np.asarray(a["links"]),
        "density_data": np.asarray(a["density_data"], np.float32),
        "sh_data": np.asarray(a["sh_data"]).astype(np.float16),
        "step_id": step_id,
        "basis_type": grid.basis_type,
        "surface_type": grid.surface_type,
    }
    for k in ("surface_data", "level_set_data", "fake_sample_std"):
        if a[k] is not None:
            data[k] = np.asarray(a[k], np.float32)
    if a["background_data"] is not None:
        data["background_links"] = np.asarray(a["background_links"])
        data["background_data"] = np.asarray(a["background_data"], np.float32)
    if a["basis_data"] is not None:
        data["basis_data"] = np.asarray(a["basis_data"], np.float32)
    if a["basis_mlp"] is not None:
        for k, v in a["basis_mlp"].items():
            data[f"basis_mlp.{k}"] = np.asarray(v, np.float32)
    np.savez(path, **data)


def load_grid(path: str, device="cuda", dtype=torch.float32) -> tuple[SparseGrid, int]:
    """Load a checkpoint (either package's, or svox2's) onto ``device``.
    Returns (grid, step_id)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=True)
    sh_data = z["sh_data"].astype(np.float32)
    density_data = z["density_data"].astype(np.float32)
    links = z["links"]

    # rows renumbered to flat order (links increase along the flattened
    # grid), the invariant of both packages; svox2's Morton-sorted
    # resample output violates it
    lf = links.reshape(-1)
    occ_rows = lf[lf >= 0]
    row_perm = None
    if occ_rows.size and np.any(np.diff(occ_rows) < 0):
        row_perm = occ_rows  # old row id at each flat-ordered position
        sh_data = sh_data[row_perm]
        if density_data.shape[0] == occ_rows.size:
            density_data = density_data[row_perm]
        lf2 = np.full_like(lf, -1)
        lf2[lf >= 0] = np.arange(occ_rows.size, dtype=np.int32)
        links = lf2.reshape(links.shape)
    surface_type = int(z["surface_type"]) if "surface_type" in z else defs.SURFACE_TYPE_NONE
    surface = None
    if surface_type != defs.SURFACE_TYPE_NONE and "surface_data" in z:
        surface = z["surface_data"].astype(np.float32)
        if row_perm is not None and surface.shape[0] == row_perm.size:
            surface = surface[row_perm]
    arrays = {
        "links": links.astype(np.int32),
        "density_data": density_data,
        "sh_data": sh_data,
        "surface_data": surface,
        "level_set_data": z["level_set_data"] if "level_set_data" in z else None,
        "fake_sample_std": z["fake_sample_std"] if "fake_sample_std" in z else None,
        "truncated_vol_render_a": np.float32(1.0),
        "radius": z["radius"] if "radius" in z else np.ones(3, np.float32),
        "center": z["center"] if "center" in z else np.zeros(3, np.float32),
        "basis_dim": sh_data.shape[1] // 3,
        "surface_type": surface_type,
        "basis_type": int(z["basis_type"]) if "basis_type" in z else defs.BASIS_TYPE_SH,
    }
    if "background_data" in z:
        arrays["background_links"] = z["background_links"].astype(np.int32)
        arrays["background_data"] = z["background_data"].astype(np.float32)
    if "basis_data" in z and z["basis_data"].size:  # an empty one (svox2's SH grids): None
        arrays["basis_data"] = z["basis_data"].astype(np.float32)
    mlp_keys = [k for k in z.files if k.startswith("basis_mlp.")]
    if mlp_keys:
        arrays["basis_mlp"] = {k.split(".", 1)[1]: z[k].astype(np.float32) for k in mlp_keys}
    step_id = int(z["step_id"]) if "step_id" in z else 0
    return SparseGrid.from_numpy(arrays, device=dev, dtype=dtype), step_id
