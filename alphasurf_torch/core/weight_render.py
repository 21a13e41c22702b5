"""Camera sweeps of the stage transitions, the counterpart of the JAX
package's ``core.weight_render`` (svox2's misc_kernel.cu grid weight render
and visibility render).

Three hand-written CUDA kernels on the card (``csrc/sweep.cu``), one thread
per camera ray, and their plain PyTorch versions here, which the wrappers
take for tensors on the CPU:

  K9c ``grid_weight_render``     fixed-step sigma march of every ray through
                                 a dense volume; each voxel keeps the largest
                                 sample weight, at its 8 corners
  K9d ``sparse_grid_visibility_render_surf``
                                 per ray, +1 at each present corner of every
                                 voxel walked up to and including the first
                                 one with a surface hit
  K9e ``sparse_grid_weight_render``
                                 K9c's march through the sparse grid; each
                                 present corner keeps the largest
                                 transmittance before a sample
                                 (surf_init_type="weight")

The marches run in float32 whatever the grid's dtype, as the JAX package
casts rays and volume; the ray set-up is computed once here for the kernel
and its plain version alike. (The JAX package's transmittance march takes
the grid's density as it is and fails on a float64 grid, its scan carry
being float32; the port reads the density in float32.) The visibility walk
runs in the grid's dtype on the CPU, as the JAX package's does, and in
float32 on the card.

The JAX package pads its last ray chunk with copies of the last ray; the
maxima of the marches do not see them, but its visibility counts do. The
port walks each ray once.

``sparse_grid_mask_render`` (K9f, mask pruning) is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..ops import dda
from ..ops.cubic import _cubic_roots_raw, cubic_coeffs_T
from .grid import CORNER_OFFSETS, SparseGrid

_NOT_PORTED = "is not ported yet (ROADMAP §1 item 7)"


def _march_prep(origins, dirs, scaling, offset, size, step_size: float):
    """Grid-space set-up of each ray (misc_kernel.cu:200-226, the JAX
    package's ``_march_prep``), float32: origins, unit directions, world
    step, and t bounds of the slab [-0.5, size - 0.5] from t = 0, capped
    at 2e3."""
    o = origins * scaling + offset
    d = dirs * scaling
    delta_scale = 1.0 / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d * delta_scale
    world_step = delta_scale[:, 0] * step_size
    safe = torch.where(d == 0, torch.full_like(d, 1e-12), d)
    t1 = (-0.5 - o) / safe
    t2 = (size - 0.5 - o) / safe
    tmin = torch.amax(torch.where(d == 0, torch.zeros_like(d), torch.minimum(t1, t2)), -1)
    tmin = torch.clamp(tmin, min=0.0)
    tmax = torch.amin(torch.where(d == 0, torch.full_like(d, 2e3), torch.maximum(t1, t2)), -1)
    tmax = torch.clamp(tmax, max=2e3)
    return o, d, world_step, tmin, tmax


def _corner_offsets(Y: int, Z: int, device) -> torch.Tensor:
    """Flat offsets of a voxel's 8 corners in an (X, Y, Z) lattice."""
    return torch.as_tensor(((CORNER_OFFSETS[:, 0] * Y + CORNER_OFFSETS[:, 1]) * Z
                            + CORNER_OFFSETS[:, 2]).astype(np.int64), device=device)


def _march_plain(o, d, world_step, tmin, tmax, size, step_size: float, stop_thresh: float,
                 n_steps: int, corner_values, scatter) -> int:
    """The fixed-step march of every ray as the JAX package's scans run it
    (``_dense_weight_chunk``, ``_sparse_transmit_chunk``): t = tmin + k step
    for k < n_steps while t <= tmax and the transmittance is >=
    stop_thresh; sigma the trilinear sum, in corner order, of
    ``corner_values(l)`` (B, 8) at the sample's voxel l and fraction (JAX's
    ``_voxel_and_frac``); a hit where sigma > 1e-8; then
    ``scatter(l, hit, log_T, log_att)`` and log_T += log_att. Returns the
    number of samples taken (active steps)."""
    log_T = torch.zeros_like(tmin)
    n_samples = 0
    for k in range(n_steps):
        t = tmin + torch.full_like(tmin, float(k)) * step_size
        active = (t <= tmax) & (torch.exp(log_T) >= stop_thresh)
        n_active = int(active.sum())
        if n_active == 0:
            break
        n_samples += n_active
        pos = torch.minimum(torch.maximum(o + t[:, None] * d, torch.zeros_like(o)), size - 1.0)
        l = torch.minimum(pos.to(torch.int32), (size - 2).to(torch.int32)).long()
        fr = pos - l
        v8 = corner_values(l)
        sigma = None
        for c, (dx, dy, dz) in enumerate(CORNER_OFFSETS.tolist()):
            w = ((fr[:, 0] if dx else 1 - fr[:, 0]) * (fr[:, 1] if dy else 1 - fr[:, 1])) * (
                fr[:, 2] if dz else 1 - fr[:, 2])
            v = w * v8[:, c]
            sigma = v if sigma is None else sigma + v
        hit = active & (sigma > 1e-8)
        log_att = torch.where(hit, -world_step * sigma, torch.zeros_like(sigma))
        scatter(l, hit, log_T, log_att)
        log_T = log_T + log_att
    return n_samples


def _weight_march_plain(vol, wt, o, d, world_step, tmin, tmax, step_size: float,
                        stop_thresh: float, n_steps: int) -> int:
    """Plain version of K9c (``_dense_weight_chunk``): the march, with the
    scatter-max of each hit sample's weight T (1 - exp(log_att)) into
    ``wt`` (X*Y*Z,) float32 at its voxel's 8 corners. Returns the number of
    samples taken."""
    X, Y, Z = vol.shape
    vol_flat = vol.reshape(-1)
    offs = _corner_offsets(Y, Z, vol.device)

    def corners(l):
        return ((l[:, 0] * Y + l[:, 1]) * Z + l[:, 2])[:, None] + offs

    def scatter(l, hit, log_T, log_att):
        w = torch.where(hit, torch.exp(log_T) * (1.0 - torch.exp(log_att)),
                        torch.zeros_like(log_att))
        wt.scatter_reduce_(0, corners(l).reshape(-1), w[:, None].expand(-1, 8).reshape(-1),
                           "amax")

    size = torch.tensor([X, Y, Z], dtype=torch.float32, device=vol.device)
    return _march_plain(o, d, world_step, tmin, tmax, size, step_size, stop_thresh, n_steps,
                        lambda l: vol_flat[corners(l)], scatter)


def grid_weight_render(vol, cameras, world_offset, world_scaling, step_size: float = 0.5,
                       stop_thresh: float = 0.2, chunk: int = 65536) -> torch.Tensor:
    """K9c: the largest ray weight at each vertex of the dense density
    volume ``vol`` (X, Y, Z) sampled at the new resolution, over every ray
    of ``cameras`` (resample's weight threshold, svox2.py:4063-4091).

    ``world_offset`` / ``world_scaling`` are the grid's (3,) transform; the
    samples sit at the voxel centres of the new lattice (offset * gsz - 0.5).
    Returns (X, Y, Z) float32. The kernel on the card (one launch per
    camera), the plain version on the CPU (rays in chunks of ``chunk``)."""
    vol = vol.detach().to(torch.float32).contiguous()
    dev = vol.device
    reso = tuple(vol.shape)
    gsz = np.asarray(reso, np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    scaling = torch.as_tensor(np.asarray(world_scaling.detach().cpu()) * gsz, **f32)
    offset = torch.as_tensor(np.asarray(world_offset.detach().cpu()) * gsz - 0.5, **f32)
    size = torch.as_tensor(gsz, **f32)
    diag = math.sqrt(sum((r - 1) ** 2 for r in reso))
    n_steps = int(math.ceil(diag / step_size)) + 2
    n3 = int(np.prod(reso))
    if vol.is_cuda:
        bits = torch.zeros(n3, dtype=torch.int32, device=dev)
        for cam in cameras:
            rays = cam.gen_rays(device=dev)
            o, d, ws, tmin, tmax = (x.contiguous() for x in _march_prep(
                rays.origins, rays.dirs, scaling, offset, size, step_size))
            kernels.weight_march(o, d, ws, tmin, tmax, vol, step_size, stop_thresh, n_steps, bits)
        return bits.view(torch.float32).reshape(reso)
    wt = torch.zeros(n3, **f32)
    for cam in cameras:
        rays = cam.gen_rays(device=dev)
        for s in range(0, rays.origins.shape[0], chunk):
            prep = _march_prep(rays.origins[s:s + chunk], rays.dirs[s:s + chunk], scaling, offset,
                               size, step_size)
            _weight_march_plain(vol, wt, *prep, step_size, stop_thresh, n_steps)
    return wt.reshape(reso)


def _transmit_march_plain(links, dens, out, o, d, world_step, tmin, tmax, step_size: float,
                          stop_thresh: float, n_steps: int) -> int:
    """Plain version of K9e (``_sparse_transmit_chunk``): the march through
    the sparse grid, raw density at present corners and 0 at empty ones,
    with the scatter-max of the transmittance before each hit sample into
    ``out`` (cap + 1,) float32 at the present corner links (empty ones into
    the last slot). Returns the number of samples taken."""
    X, Y, Z = links.shape
    cap = out.shape[0] - 1
    links_flat = links.reshape(-1)
    offs = _corner_offsets(Y, Z, links.device)

    def corner_links(l):
        return links_flat[((l[:, 0] * Y + l[:, 1]) * Z + l[:, 2])[:, None] + offs]

    def values(l):
        lk = corner_links(l)
        return torch.where(lk >= 0, dens[lk.clamp(min=0).long()], torch.zeros((), device=lk.device))

    def scatter(l, hit, log_T, log_att):
        lk = corner_links(l).long()
        T = torch.where(hit, torch.exp(log_T), torch.zeros_like(log_T))
        idx = torch.where(lk >= 0, lk, torch.full_like(lk, cap))
        out.scatter_reduce_(0, idx.reshape(-1), T[:, None].expand(-1, 8).reshape(-1), "amax")

    size = torch.tensor([X, Y, Z], dtype=torch.float32, device=links.device)
    return _march_plain(o, d, world_step, tmin, tmax, size, step_size, stop_thresh, n_steps,
                        values, scatter)


def sparse_grid_weight_render(grid: SparseGrid, cameras, step_size: float = 0.5,
                              stop_thresh: float = 0.0, chunk: int = 65536) -> torch.Tensor:
    """K9e: the largest transmittance before any sample of the rays of
    ``cameras`` at each vertex of the grid (surf_init_type="weight",
    svox2.py:3122-3146). Returns (capacity,) float32. The kernel on the
    card (one launch per camera), the plain version on the CPU (rays in
    chunks of ``chunk``)."""
    dev = grid.links.device
    reso = grid.reso
    gsz = np.asarray(reso, np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    scaling = torch.as_tensor(np.asarray(grid.scaling.detach().cpu()) * gsz, **f32)
    offset = torch.as_tensor(np.asarray(grid.offset.detach().cpu()) * gsz, **f32)
    size = torch.as_tensor(gsz, **f32)
    diag = math.sqrt(sum((r - 1) ** 2 for r in reso))
    n_steps = int(math.ceil(diag / step_size)) + 2
    dens = grid.density_data.detach()[:, 0].to(torch.float32).contiguous()
    if grid.links.is_cuda:
        bits = torch.zeros(grid.capacity, dtype=torch.int32, device=dev)
        for cam in cameras:
            rays = cam.gen_rays(device=dev)
            o, d, ws, tmin, tmax = (x.contiguous() for x in _march_prep(
                rays.origins, rays.dirs, scaling, offset, size, step_size))
            kernels.transmit_march(o, d, ws, tmin, tmax, grid.links, dens, step_size, stop_thresh,
                                   n_steps, bits)
        return bits.view(torch.float32)
    out = torch.zeros(grid.capacity + 1, **f32)
    for cam in cameras:
        rays = cam.gen_rays(device=dev)
        for s in range(0, rays.origins.shape[0], chunk):
            prep = _march_prep(rays.origins[s:s + chunk], rays.dirs[s:s + chunk], scaling, offset,
                               size, step_size)
            _transmit_march_plain(grid.links, dens, out, *prep, step_size, stop_thresh, n_steps)
    return out[:grid.capacity]


def sparse_grid_mask_render(grid: SparseGrid, origins_w, dirs_w, near_clip=0.0, chunk=16384):
    """Per-vertex mask of the voxels masked rays cross (mask pruning, K9f)."""
    raise NotImplementedError(f"sparse_grid_mask_render (K9f) {_NOT_PORTED}")


def all_crossings(reso, origins, dirs, tnear, tmax):
    """Every voxel segment of every ray, sorted (the JAX package's
    ``render.surface.all_crossings``): starts at tnear and at each
    interior-plane crossing in (tnear + 1e-9, tmax - 1e-9); each segment's
    voxel is the floor of its midpoint. Returns seg_start, seg_end,
    seg_valid (B, S), the voxel l (B, S, 3) clipped to the lattice and
    in_bounds (B, S)."""
    dt = origins.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=origins.device)
    parts = []
    for a in range(3):
        planes = torch.arange(1, reso[a] - 1, dtype=dt, device=origins.device)
        da = dirs[:, a:a + 1]
        safe = torch.where(da == 0, torch.full_like(da, 1e-12), da)
        t = (planes[None, :] - origins[:, a:a + 1]) / safe
        ok = (da != 0) & (t > tnear[:, None] + 1e-9) & (t < tmax[:, None] - 1e-9)
        parts.append(torch.where(ok, t, inf))
    ts = torch.sort(torch.cat([tnear[:, None]] + parts, dim=1), dim=1).values
    last = torch.where(torch.isfinite(ts[:, -1:]), tmax[:, None], inf)
    seg_end = torch.minimum(torch.cat([ts[:, 1:], last], dim=1), tmax[:, None])
    seg_valid = torch.isfinite(ts) & torch.isfinite(seg_end) & (seg_end > ts + 1e-9)
    tmid = 0.5 * (ts + torch.where(seg_valid, seg_end, ts))
    pos = origins[:, None, :] + tmid[..., None] * dirs[:, None, :]
    l = torch.floor(pos).to(torch.int64)
    hi = torch.tensor([r - 2 for r in reso], dtype=torch.int64, device=origins.device)
    in_bounds = torch.all(l >= 0, dim=-1) & torch.all(l <= hi, dim=-1)
    l = torch.minimum(torch.clamp(l, min=0), hi)
    return ts, seg_end, seg_valid, l, in_bounds


def _visibility_chunk_plain(links, surface, level_sets, counts, o, d, tnear, tmax) -> tuple:
    """Plain version of K9d (``_visibility_chunk``): add to ``counts``.
    Returns (segments walked, cubics the walk solves): the walk's work."""
    X, Y, Z = links.shape
    seg_start, _, seg_valid, l, in_bounds = all_crossings((X, Y, Z), o, d, tnear, tmax)
    B, S = seg_start.shape
    # l <= reso - 2 after the clip, so every corner lies in the lattice
    offs = torch.as_tensor(((CORNER_OFFSETS[:, 0] * Y + CORNER_OFFSETS[:, 1]) * Z
                            + CORNER_OFFSETS[:, 2]).astype(np.int64), device=l.device)
    base = (l[..., 0] * Y + l[..., 1]) * Z + l[..., 2]
    links8 = links.reshape(-1)[base[..., None] + offs]
    present = links8 >= 0
    all_present = torch.all(present, dim=-1)
    surf8 = surface[links8.clamp(min=0).long()] * present.to(surface.dtype)
    t0 = torch.clamp(seg_start, min=0.0)
    lf = l.to(o.dtype)
    u = o[:, None, :] + t0[..., None] * d[:, None, :] - lf
    dT = d[:, None, :].expand(B, S, 3).permute(2, 0, 1)
    f0, f1, f2, f3 = cubic_coeffs_T(surf8.permute(2, 0, 1), u.permute(2, 0, 1), dT)
    smin = torch.amin(surf8, dim=-1)
    smax = torch.amax(surf8, dim=-1)
    has_hit = torch.zeros((B, S), dtype=torch.bool, device=o.device)
    lv_oks = []
    for lv in level_sets:
        lv_ok = (lv >= smin) & (lv <= smax)
        lv_oks.append(lv_ok)
        roots = _cubic_roots_raw(f0 - lv, f1, f2, f3)[0]  # (3, B, S)
        t_real = t0[None] + roots
        frac = o[None, :, None, :] + t_real[..., None] * d[None, :, None, :] - lf[None]
        in_cube = torch.all(frac >= 0, dim=-1) & torch.all(frac <= 1, dim=-1)
        has_hit |= (lv_ok[None] & (roots > 0) & in_cube).any(0)
    has_hit &= seg_valid & in_bounds & all_present
    seg_i = torch.arange(S, device=o.device)
    first = torch.where(has_hit.any(1), torch.argmax(has_hit.to(torch.int8), dim=1),
                        torch.full((B,), S, device=o.device))
    visited = seg_valid & in_bounds & (seg_i[None, :] <= first[:, None])
    ok = visited[..., None] & present
    counts.index_add_(0, links8[ok].long(), torch.ones(int(ok.sum()), dtype=counts.dtype,
                                                       device=counts.device))
    solved = visited & all_present
    return int(visited.sum()), sum(int((solved & m).sum()) for m in lv_oks)


def sparse_grid_visibility_render_surf(grid: SparseGrid, cameras, chunk: int = 16384):
    """K9d: per vertex, how many rays of ``cameras`` reach it before the
    surface occludes them (visibility pruning, svox2.py:3204-3221).
    Returns (capacity,) float32 counts. The kernel on the card (float32
    grids, one launch per camera), the plain version on the CPU."""
    dev = grid.links.device
    surface = grid.surface_data.detach()[:, 0].contiguous()
    counts = torch.zeros(grid.capacity, dtype=torch.int32 if grid.links.is_cuda else torch.int64,
                         device=dev)
    for cam in cameras:
        rays = cam.gen_rays(device=dev)
        og, dg, _, _ = dda.preprocess_rays(grid, rays.origins, rays.dirs)
        tnear, tmax = dda.ray_bounds(grid, og, dg)
        ray_ok = torch.isfinite(tnear) & torch.isfinite(tmax) & (tnear <= tmax)
        tn = torch.where(ray_ok, tnear, torch.zeros_like(tnear))
        tx = torch.where(ray_ok, tmax, torch.full_like(tmax, -1.0))
        if grid.links.is_cuda:
            kernels.visibility(og.contiguous(), dg.contiguous(), tn.contiguous(), tx.contiguous(),
                               grid.links, surface, grid.level_set_data.float().contiguous(),
                               counts)
            continue
        for s in range(0, og.shape[0], chunk):
            e = s + chunk
            _visibility_chunk_plain(grid.links, surface, grid.level_set_data, counts, og[s:e],
                                    dg[s:e], tn[s:e], tx[s:e])
    return counts.to(torch.float32)
