"""Iso-surface point extraction, the counterpart of the JAX package's
``geometry.extract`` (svox2's ``cubic_extract_iso_pts``, svox2_kernel.cu
248-382, and ``SparseGrid.extract_pts``, svox2.py:4525-4579).

Inside every occupied cell (all 8 corners present), n^2 rays run along each
of the three axes from the cell's face, at the lattice (i, j) / (n - 1) of
the two other axes; each ray keeps the first root in [0, 1] of the cubic of
the trilinear surface minus the level set whose trilinear density at the
point passes the threshold. A grid without a surface uses its density minus
the threshold as the field.

K9g ``iso_points`` (``csrc/extract.cu``) computes the rays on the card, one
thread per (cell, axis, ray); ``_extract_cell_points`` is its plain version,
in the grid's dtype, which the CPU takes. Points come out in the JAX
package's order: cell, then axis, then the ``ij`` meshgrid of the two
offsets; rays without a point are dropped.

The mesh (``marching_tetrahedra``, ``extract_mesh``) is host code in the JAX
package and is not ported yet (ROADMAP §1 item 8).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..core.grid import CORNER_OFFSETS, SparseGrid
from ..ops.cubic import _cubic_roots_raw, cubic_coeffs_T
from ..ops.trilerp import trilerp_weights_T

_MESH = "the marching-tetrahedra mesh is not ported yet (ROADMAP §1 item 8)"


def occupied_cells(grid: SparseGrid) -> torch.Tensor:
    """Flat link-lattice ids (int64, ascending, on the grid's device) of the
    cells whose 8 corner links are all present."""
    links = grid.links
    X, Y, Z = links.shape
    ok = torch.ones((max(X - 1, 0), max(Y - 1, 0), max(Z - 1, 0)), dtype=torch.bool,
                    device=links.device)
    for dx, dy, dz in CORNER_OFFSETS.tolist():
        ok &= links[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz] >= 0
    c = torch.nonzero(ok.reshape(-1))[:, 0]
    cz, cxy = c % (Z - 1), c // (Z - 1)
    return (cxy // (Y - 1) * Y + cxy % (Y - 1)) * Z + cz


def _corner_rows(grid: SparseGrid, cells: torch.Tensor, density_thresh: float,
                 surf_lv_set: float):
    """The cells' voxel l (n, 3) int64 and, per corner, the field minus its
    level (s8) and the density (d8), both (n, 8), 0 at empty corners before
    the shift; and whether all 8 corners are present."""
    X, Y, Z = grid.reso
    z, xy = cells % Z, cells // Z
    l = torch.stack([xy // Y, xy % Y, z], -1)
    offs = torch.as_tensor(CORNER_OFFSETS, dtype=torch.int64, device=cells.device)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.int64, device=cells.device)
    cor = torch.minimum(torch.clamp(l[:, None, :] + offs, min=0), hi)
    links8 = grid.links[cor[..., 0], cor[..., 1], cor[..., 2]]
    present = links8 >= 0
    safe = links8.clamp(min=0).long()
    has_surf = grid.surface_data is not None
    field = (grid.surface_data if has_surf else grid.density_data).detach()[:, 0]
    dens = grid.density_data.detach()[:, 0]
    mask = present.to(field.dtype)
    s8 = field[safe] * mask - (surf_lv_set if has_surf else density_thresh)
    d8 = dens[safe] * mask
    return l, s8, d8, present.all(-1)


def _extract_cell_points(grid: SparseGrid, cells: torch.Tensor, n_sample: int,
                         density_thresh: float, surf_lv_set: float) -> torch.Tensor:
    """Plain version of K9g: (n_cells, 3 n^2, 3) grid-space points of the
    cells (flat ids), NaN where a ray has none, in the grid's dtype."""
    l, s8, d8, ok = _corner_rows(grid, cells.long(), density_thresh, surf_lv_set)
    dt, dev = s8.dtype, s8.device
    offs = torch.arange(n_sample, dtype=dt, device=dev) / torch.full(
        (n_sample,), float(max(n_sample - 1, 1)), dtype=dt, device=dev)
    p1 = offs.repeat_interleave(n_sample)  # meshgrid(offs, offs, indexing="ij")
    p2 = offs.repeat(n_sample)
    m = p1.shape[0]
    s8T = s8.T[:, :, None]  # (8, n, 1)
    d8T = d8.T[:, :, None]
    pts_all = []
    for axis in range(3):
        o = torch.zeros((3, 1, m), dtype=dt, device=dev)
        d = torch.zeros((3, 1, m), dtype=dt, device=dev)
        d[axis] = 1.0
        o1, o2 = [a for a in range(3) if a != axis]
        o[o1, 0], o[o2, 0] = p1, p2
        f0, f1, f2, f3 = cubic_coeffs_T(s8T, o, d)  # (n, m)
        roots = _cubic_roots_raw(f0, f1, f2, f3)[0]  # (3 slots, n, m)
        pos = o[:, None] + roots[None] * d[:, None]  # (3 comps, 3 slots, n, m)
        in01 = (roots >= 0.0) & (roots <= 1.0)
        w8 = trilerp_weights_T(torch.clamp(pos, 0.0, 1.0))  # (8, 3 slots, n, m)
        dens = w8[0] * d8T[0]  # in corner order, as the kernel sums
        for k in range(1, 8):
            dens = dens + w8[k] * d8T[k]
        valid = in01 & (dens >= density_thresh) & ok[None, :, None]
        first = torch.argmax(valid.to(torch.int8), dim=0)  # the first valid slot
        sel = torch.gather(pos, 1, first[None, None].expand(3, 1, -1, -1))[:, 0]  # (3, n, m)
        sel = sel.permute(1, 2, 0) + l[:, None, :].to(dt)
        pts_all.append(torch.where(valid.any(0)[..., None], sel, torch.full_like(sel, float("nan"))))
    return torch.cat(pts_all, dim=1)


def _cell_points(grid: SparseGrid, cells: torch.Tensor, n_sample: int, density_thresh: float,
                 surf_lv_set: float) -> torch.Tensor:
    """K9g on the card (float32 grids), its plain version on the CPU."""
    if not grid.links.is_cuda:
        return _extract_cell_points(grid, cells, n_sample, density_thresh, surf_lv_set)
    has_surf = grid.surface_data is not None
    field = (grid.surface_data if has_surf else grid.density_data).detach()[:, 0].contiguous()
    return kernels.iso_points(cells.contiguous(), grid.links, field,
                              grid.density_data.detach()[:, 0].contiguous(),
                              surf_lv_set if has_surf else density_thresh, density_thresh,
                              n_sample)


def extract_iso_points(
    grid: SparseGrid,
    n_sample: int = 5,
    density_thresh: float = 0.0,
    surf_lv_set: float = 0.0,
    cells=None,
    batch: int = 65536,
    to_world: bool = True,
    scene_scale: float = 1.0,
) -> np.ndarray:
    """Every iso-surface point of the grid as (N, 3) float32 numpy, in
    world units divided by ``scene_scale`` (``to_world``) or in grid units.
    Cells in batches of ``batch`` (one K9g launch each on the card); the
    world transform is the JAX package's, float32 points times float64
    numpy factors, rounded to float32 last."""
    if cells is None:
        cells = occupied_cells(grid)
    cells = torch.as_tensor(cells, device=grid.links.device).long()
    out = []
    for s in range(0, cells.shape[0], batch):
        pts = _cell_points(grid, cells[s:s + batch], n_sample, density_thresh,
                           surf_lv_set).reshape(-1, 3)
        out.append(pts[~torch.isnan(pts).any(-1)])
    pts = torch.cat(out).cpu().numpy() if out else np.zeros((0, 3), np.float32)
    if to_world:
        gsz = np.asarray(grid.reso, np.float64)
        radius = grid.radius.detach().cpu().numpy()
        center = grid.center.detach().cpu().numpy()
        pts = pts * (2.0 * radius / gsz) + (center - radius)
        pts = pts / scene_scale
    return pts.astype(np.float32)


def marching_tetrahedra(field: np.ndarray, level: float = 0.0, use_native: bool = True):
    """Triangulate the ``field == level`` iso-surface (the JAX package's
    host marching tetrahedra): not ported yet."""
    raise NotImplementedError(_MESH)


def extract_mesh(grid: SparseGrid, path: Optional[str] = None, level: float = 0.0,
                 density_thresh: Optional[float] = None, to_world: bool = True):
    """Mesh of the surface field (svox2.py:4583-4689): not ported yet."""
    raise NotImplementedError(_MESH)
