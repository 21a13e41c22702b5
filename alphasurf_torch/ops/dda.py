"""Ray setup in grid space, the counterpart of the JAX package's ``ops.dda``
(svox2.py:1631-1665, 1976-1980; render_util.cuh:661-681). All functions
work in grid coordinates with unit-length directions."""
from __future__ import annotations

import torch


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.full_like(d, 1e-12), d)


def preprocess_rays(grid, origins_w: torch.Tensor, dirs_w: torch.Tensor):
    """World rays -> grid-space rays (svox2.py:1631-1642): origins to grid
    coords; dirs scaled by (scaling * gsz) then renormalized. ``delta_scale``
    converts grid-space t back to world distance."""
    origins = grid.world2grid(origins_w)
    viewdirs = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    dirs = viewdirs * (grid.scaling * grid.gsz)
    delta_scale = 1.0 / torch.linalg.norm(dirs, dim=-1)
    dirs = dirs * delta_scale[..., None]
    return origins, dirs, viewdirs, delta_scale


def ray_bounds(grid, origins: torch.Tensor, dirs: torch.Tensor, atol: float = 1e-6):
    """Entry/exit t of each ray with the vertex lattice [0, gsz-1]^3
    (svox2.py:1651-1665); tnear = 0 for origins already inside."""
    gsz = grid.gsz
    safe_dirs = _safe(dirs)
    ts_lo = (0.0 - origins) / safe_dirs
    ts_hi = (gsz - 1.0 - origins) / safe_dirs
    ts = torch.cat([ts_lo, ts_hi], dim=-1)  # (B, 6)
    pts = origins[..., None, :] + ts[..., :, None] * dirs[..., None, :]
    inside = torch.all(pts <= gsz - 1.0 + 1e-6, dim=-1) & torch.all(pts >= -1e-6, dim=-1)
    valid = (ts >= 0) & inside
    inf = torch.full_like(ts, float("inf"))
    tnear = torch.amin(torch.where(valid, ts, inf), dim=-1)
    tmax = torch.amax(torch.where(valid, ts, -inf), dim=-1)
    origin_inside = grid.within_grid(origins, atol=atol)
    tnear = torch.where(origin_inside, torch.zeros_like(tnear), tnear)
    return tnear, tmax


def spheric_bounds(grid, origins: torch.Tensor, dirs: torch.Tensor, near_clip: float):
    """Concentric-sphere ray clip (use_spheric_clip, render_util.cuh:661-681).
    Rays that miss either sphere get (tmin, tmax) = (1e-9, 0), i.e. empty."""
    s = 2.0 / grid.gsz
    o = (origins + 0.5) * s - 1.0
    d = dirs * s
    q2a = 2.0 * torch.sum(d * d, dim=-1)
    qb = 2.0 * torch.sum(o * d, dim=-1)
    f = qb * qb - 2.0 * q2a * torch.sum(o * o, dim=-1)
    det_far = f + 2.0 * q2a
    det_near = f + 2.0 * q2a * (1.0 - near_clip) ** 2
    ok = (det_far >= 0) & (det_near >= 0)
    safe_q = torch.where(q2a == 0, torch.ones_like(q2a), q2a)
    tmax = (-qb + torch.sqrt(torch.clamp(det_far, min=0.0))) / safe_q
    tmin = (-qb - torch.sqrt(torch.clamp(det_near, min=0.0))) / safe_q
    tmin = torch.where(ok, tmin, torch.full_like(tmin, 1e-9))
    tmax = torch.where(ok, tmax, torch.zeros_like(tmax))
    return tmin, tmax


def voxel_plane_ts(origins: torch.Tensor, dirs: torch.Tensor, l: torch.Tensor):
    """Entry (close) and exit (far) t of the ray with voxel ``l``'s slab
    (svox2.py:1976-1980): close plane per axis l + (d<0), far plane
    l + (d>=0); close_t = max over axes, far_t = min."""
    lf = l.to(origins.dtype)
    neg = (dirs < 0).to(origins.dtype)
    close_planes = lf + neg
    far_planes = lf + (1.0 - neg)
    safe_dirs = _safe(dirs)
    ct = (close_planes - origins) / safe_dirs
    ft = (far_planes - origins) / safe_dirs
    ct = torch.where(torch.isfinite(ct), ct, torch.full_like(ct, -float("inf")))
    ft = torch.where(torch.isfinite(ft), ft, torch.full_like(ft, float("inf")))
    return torch.amax(ct, dim=-1), torch.amin(ft, dim=-1)


_EPS_INT = 1e-6


def next_crossing(origins: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor,
                  atol: float = _EPS_INT) -> torch.Tensor:
    """t of the next axis-plane crossing after ``t`` (svox2.py:1451-1505,
    without the in-grid check: callers compare against tmax). The on-plane
    band scales with |position|, as the JAX package's: float32 roundoff of
    o + t*d is relative, and an absolute band lets the walk stall at a plane
    until its step budget runs out. Each operation is the JAX package's, in
    its order, so that the float32 walk visits the same voxels."""
    pos = origins + t[..., None] * dirs
    tol = atol * 2.0 * (1.0 + torch.abs(pos))
    fl = torch.floor(pos)
    on_plane = torch.abs(fl - pos) <= tol
    ce = torch.ceil(pos)
    on_plane_c = torch.abs(ce - pos) <= tol
    next_up = torch.where(on_plane_c, ce + 1.0, ce)
    next_dn = torch.where(on_plane, fl - 1.0, fl)
    next_plane = torch.where(dirs >= 0, next_up, next_dn)
    steps = (next_plane - pos) / _safe(dirs)
    bad = (steps <= 0) | (dirs == 0) | ~torch.isfinite(steps)
    steps = torch.where(bad, torch.full_like(steps, float("inf")), steps)
    return t + torch.amin(steps, dim=-1)


def voxel_between(origins: torch.Tensor, dirs: torch.Tensor, t0: torch.Tensor,
                  t1: torch.Tensor, reso):
    """Voxel holding the midpoint of the segment [t0, t1] (find_mid_voxel,
    svox2.py:1507-1513), and whether it lies inside the lattice."""
    tm = 0.5 * (t0 + t1)
    pos = origins + tm[..., None] * dirs
    l = torch.floor(pos).to(torch.int32)
    hi = torch.tensor([r - 2 for r in reso], dtype=torch.int32, device=l.device)
    in_bounds = torch.all(l >= 0, dim=-1) & torch.all(l <= hi, dim=-1)
    return l, in_bounds
