"""Plenoxels-style density renderer ("cuvol"), the counterpart of the JAX
package's ``render.cuvol`` (svox2's ``trace_ray_cuvol``): the warm-start
stage's renderer.

Two renderers and the occupancy they skip by, each a hand-written CUDA
kernel on the card (``csrc/cuvol.cu``, ``csrc/occupancy.cu``) and a plain
PyTorch version here, which the wrappers take for tensors that lie on the
CPU:

  K1d ``density_occupancy_words`` which voxels can contribute (a present
                                  corner with density > 0), in K1's packed
                                  words, so that K2 enumerates the pool
  K8  ``volume_render_cuvol_packed`` per pool entry, the fixed-step samples
                                  of the global lattice t = tmin + k*step in
                                  the segment, composited per ray; backward
                                  into the density and SH rows
  K10 ``volume_render_cuvol``     the dense fixed-step march (eval images and
                                  depth, and the warm start of a step that
                                  is not packed or has no occupancy);
                                  backward into the density and SH rows

As in the JAX package, the packed renderer drops the samples of the outer
half-voxel band (outside the vertex lattice but inside the sample domain
[-0.5, gsz-0.5]), which the dense march renders with an edge-clamped
trilerp: the two agree only where the boundary voxels are empty.

Gradients: when density, SH, a learned basis or the background requires
grad, the plain path on the CPU is differentiated by autograd (the pool is
a constant of the parameters, as the JAX package's stop_gradient makes
it); on the card ``_PackedCuvolFn`` runs K8's forward and backward and
``_DenseCuvolFn`` K10's, for the cotangents of ``rgb``, ``depth`` and
``log_transmit``, the per-ray basis ``sh_mult`` and background colour
among their inputs.

A grid with an MSI background composites it behind the density in both
renderers: K13 (``render.background``) gives each ray its background colour,
which K8 and K10 take where they took the brightness; their backward
carries the colour's cotangent to K13's backward kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..core.grid import CORNER_OFFSETS, SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Rays
from ..core.sh import eval_basis
from ..ops import dda
from ..ops.trilerp import trilerp_weights_T, voxel_of
from .background import background_color
from .surface import (Pool, _clip, _excl_cumsum, _sum0, compact_crossings_packed,
                      pack_occupancy_bits, unpack_occupancy_bits)


# ---------------------------------------------------------------------------
# K1d: density occupancy
# ---------------------------------------------------------------------------

def _density_occupancy_plain(grid: SparseGrid) -> torch.Tensor:
    """Plain version of K1d, as the JAX package's ``density_occupancy``
    (cuvol.py:30-62): per-voxel bool (X-1, Y-1, Z-1), the max over present
    corners of density > 0. A density table shorter than the capacity
    (UDF_ALPHA's) is read at the clipped row, as JAX's gather clips."""
    links = grid.links
    present = links >= 0
    rows = grid.density_data[:, 0].detach()
    safe = torch.clamp(links, 0, min(grid.capacity, rows.shape[0]) - 1).long()
    dens = torch.where(present, rows[safe], torch.full_like(rows[:1], -math.inf))
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                s = dens[dx : dens.shape[0] - 1 + dx,
                         dy : dens.shape[1] - 1 + dy,
                         dz : dens.shape[2] - 1 + dz]
                out = s if out is None else torch.maximum(out, s)
    return out > 0


def density_occupancy_words(grid: SparseGrid) -> torch.Tensor:
    """K1d: the cuvol occupancy as K1's bit-packed (X-1, Y-1,
    ceil((Z-1)/32)) int32 words, which K2 reads. The kernel on a CUDA
    grid, the plain version on the CPU."""
    if not grid.links.is_cuda:
        return pack_occupancy_bits(_density_occupancy_plain(grid))
    rows = grid.density_data.detach()[:, 0]
    if rows.shape[0] < grid.capacity:  # a per-level-set table: each row reads the clipped one
        rows = rows[torch.clamp(torch.arange(grid.capacity, device=rows.device),
                                max=rows.shape[0] - 1)]
    return kernels.density_occupancy(grid.links, rows.contiguous())


def density_occupancy(grid: SparseGrid) -> torch.Tensor:
    """Per-voxel bool (X-1, Y-1, Z-1): can this voxel contribute to the
    cuvol march?"""
    return unpack_occupancy_bits(density_occupancy_words(grid), grid.reso[2] - 1)


# ---------------------------------------------------------------------------
# ray setup
# ---------------------------------------------------------------------------

def _cuvol_bounds(grid: SparseGrid, origins, dirs, opt: RenderOptions):
    """Sample-domain bounds of the cuvol march: planes at -0.5 / gsz-0.5
    (svox2.py:1239-1248), near-clipped (cuvol.py:65-76)."""
    gsz = grid.gsz
    safe_dirs = torch.where(dirs == 0, torch.full_like(dirs, 1e-12), dirs)
    t1 = (-0.5 - origins) / safe_dirs
    t2 = (gsz - 0.5 - origins) / safe_dirs
    tmin = torch.where(dirs == 0, torch.full_like(t1, -1e9), torch.minimum(t1, t2))
    tmin = torch.clamp(torch.amax(tmin, dim=-1), min=opt.near_clip)
    tmaxs = torch.where(dirs == 0, torch.full_like(t1, 1e9), torch.maximum(t1, t2))
    return tmin, torch.amin(tmaxs, dim=-1)


def max_steps_for(grid: SparseGrid, opt: RenderOptions) -> int:
    """Static bound on ray-march steps: grid diagonal / step size
    (cuvol.py:291-294)."""
    diag = math.sqrt(sum((r - 1) ** 2 for r in grid.reso))
    return int(math.ceil(diag / opt.step_size)) + 2


def n_slots(opt: RenderOptions) -> int:
    """Samples a voxel segment can hold: ceil(sqrt(3)/step) + 1."""
    return int(math.ceil(math.sqrt(3.0) / opt.step_size)) + 1


def _prep_rays(grid: SparseGrid, rays: Rays, opt: RenderOptions):
    """Grid-space rays, their view directions and world step scale, and the
    cuvol bounds (sphere or sample box)."""
    origins, dirs, viewdirs, delta_scale = dda.preprocess_rays(grid, rays.origins, rays.dirs)
    if opt.use_spheric_clip:
        tmin, tmax = dda.spheric_bounds(grid, origins, dirs, opt.near_clip)
    else:
        tmin, tmax = _cuvol_bounds(grid, origins, dirs, opt)
    return origins, dirs, viewdirs, delta_scale, tmin, tmax


def _prep(grid: SparseGrid, rays: Rays, opt: RenderOptions):
    """``_prep_rays`` with the rays' basis ``sh_mult`` in the place of
    their view directions."""
    origins, dirs, viewdirs, *rest = _prep_rays(grid, rays, opt)
    return (origins, dirs, eval_basis(grid, viewdirs), *rest)


def _corner_links(grid: SparseGrid, lT: torch.Tensor) -> torch.Tensor:
    """(8, ...) links of the corners of voxels lT (3, ...), clamped into the
    lattice (gather_corner_links)."""
    X, Y, Z = grid.reso
    idx = []
    for c in range(8):
        cx = torch.clamp(lT[0] + int(CORNER_OFFSETS[c, 0]), 0, X - 1).long()
        cy = torch.clamp(lT[1] + int(CORNER_OFFSETS[c, 1]), 0, Y - 1).long()
        cz = torch.clamp(lT[2] + int(CORNER_OFFSETS[c, 2]), 0, Z - 1).long()
        idx.append((cx * Y + cy) * Z + cz)
    return grid.links.reshape(-1)[torch.stack(idx, 0)]


def _corner_rows(grid: SparseGrid, links8: torch.Tensor):
    """Corner densities (8, ...) and SH rows (8, ..., 3 bd), 0 where a link
    is absent (fetch_links); differentiable in the rows."""
    mask = (links8 >= 0).to(grid.density_data.dtype)
    safe = torch.clamp(links8, 0, grid.capacity - 1).long()
    return grid.density_data[safe, 0] * mask, grid.sh_data[safe] * mask[..., None]


# ---------------------------------------------------------------------------
# K8: the packed renderer
# ---------------------------------------------------------------------------

def _entry_samples_plain(grid: SparseGrid, opt: RenderOptions, pool: Pool, origins, dirs,
                         sh_mult, delta_scale, tmin, tmax):
    """Plain version of K8's per-entry work (cuvol.py:161-240): per pool
    entry (minor axis M) the S fixed-step slots (leading axis). Returns t,
    active (S, M), sigma before the relu (S, M), the clipped colours
    (3, S, M) and log_att (S, M), 0 where inactive."""
    rid = pool.ray_id.long()
    S = n_slots(opt)
    step = opt.step_size
    dtype = origins.dtype
    close_t, far_t = pool.close_t, pool.far_t
    tmin_e = tmin[rid]
    k0 = torch.ceil((close_t - tmin_e) / step - 1e-9)
    slots = torch.arange(S, dtype=dtype, device=origins.device)[:, None]
    t = tmin_e[None, :] + (k0[None, :] + slots) * step
    active = (t < far_t[None, :]) & (t >= close_t[None, :] - 1e-9)

    lT = pool.l.T
    sigma8, sh8 = _corner_rows(grid, _corner_links(grid, lT))  # (8, M), (8, M, 3 bd)
    shmT = sh_mult[rid].T
    bd = grid.basis_dim
    corner_rgb = []
    for ch in range(3):
        acc = None
        for b in range(bd):
            term = sh8[:, :, ch * bd + b] * shmT[b][None, :]
            acc = term if acc is None else acc + term
        corner_rgb.append(acc)  # (8, M)

    frac = origins[rid].T[:, None, :] + t[None] * dirs[rid].T[:, None, :] - lT[:, None, :].to(dtype)
    frac = _clip(torch.where(active[None], frac, torch.full_like(frac, 0.5)), 0.0, 1.0)
    w8 = trilerp_weights_T(frac)  # (8, S, M)
    sigma = _sum0(w8 * sigma8[:, None, :])
    rgb = torch.stack([_clip(_sum0(w8 * corner_rgb[ch][:, None, :]) + 0.5, lo=0.0)
                       for ch in range(3)], 0)
    ws = (step * delta_scale[rid])[None, :].expand(S, -1)
    if opt.last_sample_opaque:
        ws = torch.where(t + step > tmax[rid][None, :], torch.full_like(ws, 1e9), ws)
    log_att = torch.where(active, -ws * torch.relu(sigma), torch.zeros_like(sigma))
    return t, active, sigma, rgb, log_att


def _composite_cuvol_plain(offsets, t, active, sigma, rgb, log_att, bg,
                           depth_sigma_thresh) -> dict:
    """Per-ray compositing of the slots in (entry, slot) order
    (cuvol.py:242-287), laid out per ray (B, E*S) so that every prefix is a
    per-ray scan, not the JAX version's chunk-wide cumsum minus a per-ray
    base (which cancels in float32). ``bg``: the brightness, or the (B, 3)
    background colour of ``background_color``."""
    B = offsets.shape[0] - 1
    S, M = t.shape
    dev = t.device
    n_e = offsets[1:] - offsets[:-1]
    E = max(int(n_e.max()) if B > 0 and M > 0 else 0, 1)
    ray = torch.repeat_interleave(torch.arange(B, device=dev), n_e)
    pos = torch.arange(M, device=dev) - offsets[ray]

    def dense(x):  # (S, M) -> (B, E*S), zero-padded
        out = torch.zeros((B, E, S), dtype=x.dtype, device=dev)
        out[ray, pos] = x.T
        return out.reshape(B, E * S)

    la = dense(log_att)
    act = dense(active)
    tt = dense(t)
    zero = torch.zeros_like(la)
    weight = torch.where(act, torch.exp(_clip(_excl_cumsum(la), hi=0.0)) * (1.0 - torch.exp(la)),
                         zero)
    log_T = la.sum(dim=1)
    rgb_acc = torch.stack([(weight * dense(rgb[ch])).sum(dim=1) for ch in range(3)], -1)
    out = {
        "rgb": rgb_acc + torch.exp(log_T)[:, None] * bg,
        "depth": (weight * tt).sum(dim=1),
        "log_transmit": log_T,
    }
    if depth_sigma_thresh is not None:
        hit = act & (dense(sigma) > depth_sigma_thresh)
        t_sig = torch.where(hit, tt, torch.full_like(tt, math.inf)).amin(dim=1)
        out["depth_sigma_thresh"] = torch.where(torch.isfinite(t_sig), t_sig,
                                                torch.zeros_like(t_sig))
    return out


class _CuvolChunk(NamedTuple):
    """What a chunk's forward and backward share besides the parameters."""

    grid: SparseGrid
    opt: RenderOptions
    pool: Pool
    rays: tuple  # (origins, dirs, sh_mult, delta_scale, tmin, tmax), float32
    depth_sigma_thresh: float | None
    bg_rgb: torch.Tensor | None = None  # (B, 3), K13's background colour (detached)


def _k8_args(c: _CuvolChunk, density, sh) -> tuple:
    p = c.pool
    return (p.offsets, p.l, p.close_t, p.far_t, *c.rays, c.grid.links, density, sh,
            c.opt.step_size, n_slots(c.opt), c.opt.last_sample_opaque,
            c.opt.background_brightness)


def _k8_forward(c: _CuvolChunk, density, sh, save_entry_pre: bool) -> dict:
    return kernels.cuvol_forward(*_k8_args(c, density, sh), c.depth_sigma_thresh, save_entry_pre,
                                 bg_rgb=c.bg_rgb)


def _cotangents(g_rgb, g_depth, g_log_T, log_T) -> tuple:
    """The output cotangents for K8's and K10's backward: rgb's (zeros for
    None) and those of depth and log_T (None, or contiguous)."""
    if g_rgb is None:
        g_rgb = torch.zeros((log_T.shape[0], 3), dtype=torch.float32, device=log_T.device)
    return tuple(None if g is None else g.contiguous() for g in (g_rgb, g_depth, g_log_T))


def _input_grads(ctx, g_rgb, log_T, grads) -> tuple:
    """The Functions' gradients of (density, sh, bg_rgb, sh_mult, chunk)
    from the kernel's (g_density, g_sh[, g_sh_mult]): bg_rgb's is
    g_rgb exp(log_T)."""
    need = ctx.needs_input_grad
    g_density, g_sh, *g_shm = grads
    g_bg = g_rgb * torch.exp(log_T)[:, None] if need[2] else None
    return (g_density[:, None] if need[0] else None, g_sh if need[1] else None, g_bg,
            g_shm[0] if need[3] else None, None)


def _wants_grad(grid: SparseGrid, bg_rgb, sh_mult) -> bool:
    """Is a renderer's Function needed: grad on, and density, SH, the
    background colour or the basis requiring it?"""
    return torch.is_grad_enabled() and (
        grid.density_data.requires_grad or grid.sh_data.requires_grad
        or (bg_rgb is not None and bg_rgb.requires_grad) or sh_mult.requires_grad)


class _PackedCuvolFn(torch.autograd.Function):
    """K8 forward and backward on the card. ``rgb``, ``depth`` and ``log_T``
    carry the gradient to density and SH, to the background colour
    ``bg_rgb`` (the chunk's, an input here so that its cotangent reaches
    K13's backward) and to the per-ray basis ``sh_mult`` (likewise, for a
    learned basis); ``t_sig`` (the depth_sigma_thresh output) takes none by
    construction."""

    @staticmethod
    def forward(ctx, density, sh, bg_rgb, sh_mult, chunk: _CuvolChunk):
        d, s = density.detach()[:, 0], sh.detach()
        out = _k8_forward(chunk, d, s, save_entry_pre=True)
        ctx.chunk = chunk
        ctx.save_for_backward(out["log_T"], out["entry_pre"])
        ctx.set_materialize_grads(False)
        t_sig = out["t_sig"] if out["t_sig"] is not None else out["depth"].new_zeros(0)
        ctx.mark_non_differentiable(t_sig)
        return out["rgb"], out["depth"], out["log_T"], t_sig

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_log_T, _g_t_sig):
        c = ctx.chunk
        log_T, entry_pre = ctx.saved_tensors
        g_rgb, g_depth, g_log_T = _cotangents(g_rgb, g_depth, g_log_T, log_T)
        grid = c.grid
        grads = kernels.cuvol_backward(
            *_k8_args(c, grid.density_data.detach()[:, 0], grid.sh_data.detach()), log_T,
            entry_pre, g_rgb, bg_rgb=c.bg_rgb, want_sh_mult=ctx.needs_input_grad[3],
            g_depth=g_depth, g_log_T=g_log_T)
        return _input_grads(ctx, g_rgb, log_T, grads)


def cuvol_pool(grid: SparseGrid, origins, dirs, tmin_cu, tmax_cu, words) -> Pool:
    """K2's pool of the occupied voxel segments of each grid-space ray within
    both the vertex lattice and the cuvol bounds (cuvol.py:130-146)."""
    tnear_v, tmax_v = dda.ray_bounds(grid, origins, dirs)
    tnear = torch.maximum(tnear_v, tmin_cu)
    tmaxp = torch.minimum(tmax_v, tmax_cu)
    ray_ok = torch.isfinite(tnear) & torch.isfinite(tmaxp) & (tnear <= tmaxp)
    return compact_crossings_packed(
        grid, origins, dirs,
        torch.where(ray_ok, tnear, torch.zeros_like(tnear)),
        torch.where(ray_ok, tmaxp, torch.full_like(tmaxp, -1.0)),
        words,
    )


def _check_grid(grid: SparseGrid) -> None:
    """The JAX renderers concatenate the density and SH rows
    (cuvol.py:156, 354), which raises on UDF_ALPHA's per-level-set density
    table with a TypeError; so does the port."""
    if grid.capacity != grid.density_data.shape[0]:
        raise TypeError(
            f"the cuvol renderers read one density row a vertex row: density_data has "
            f"{grid.density_data.shape[0]} rows, sh_data {grid.capacity}")


def volume_render_cuvol_packed(
    grid: SparseGrid,
    rays: Rays,
    opt: RenderOptions,
    entries_per_ray: float = 16.0,
    occupancy: torch.Tensor | None = None,
    depth_sigma_thresh: float | None = None,
) -> dict:
    """Packed-pool cuvol renderer, the warm-start path (cuvol.py:79-288):
    rgb, depth, log_transmit, n_occupied and pool_overflow (always 0: the
    port's pool is exact), plus depth_sigma_thresh when asked.
    ``occupancy`` are the words of ``density_occupancy_words``;
    ``entries_per_ray`` is accepted for signature parity."""
    _check_grid(grid)
    with torch.no_grad():
        origins, dirs, viewdirs, delta_scale, tmin_cu, tmax_cu = _prep_rays(grid, rays, opt)
        words = density_occupancy_words(grid) if occupancy is None else occupancy
        pool = cuvol_pool(grid, origins, dirs, tmin_cu, tmax_cu, words)
    sh_mult = eval_basis(grid, viewdirs)  # under autograd: a learned basis's gradient
    bg = background_color(grid, opt, origins, dirs, delta_scale)
    if origins.is_cuda:
        bg_rgb = None if bg is None else bg[0]
        chunk = _CuvolChunk(grid, opt, pool, tuple(x.detach().contiguous() for x in (
            origins, dirs, sh_mult, delta_scale, tmin_cu, tmax_cu)), depth_sigma_thresh,
            None if bg_rgb is None else bg_rgb.detach().contiguous())
        if _wants_grad(grid, bg_rgb, sh_mult):
            rgb, depth, log_T, t_sig = _PackedCuvolFn.apply(grid.density_data, grid.sh_data,
                                                            bg_rgb, sh_mult, chunk)
        else:
            k = _k8_forward(chunk, grid.density_data.detach()[:, 0], grid.sh_data.detach(), False)
            rgb, depth, log_T, t_sig = k["rgb"], k["depth"], k["log_T"], k["t_sig"]
        out = {"rgb": rgb, "depth": depth, "log_transmit": log_T}
        if depth_sigma_thresh is not None:
            out["depth_sigma_thresh"] = t_sig
    else:
        smp = _entry_samples_plain(grid, opt, pool, origins, dirs, sh_mult, delta_scale, tmin_cu,
                                   tmax_cu)
        out = _composite_cuvol_plain(pool.offsets, *smp,
                                     opt.background_brightness if bg is None else bg[0],
                                     depth_sigma_thresh)
    if bg is not None:
        out["log_transmit"] = out["log_transmit"] + bg[1]
    out["n_occupied"] = pool.n_occupied
    out["pool_overflow"] = 0
    return out


# ---------------------------------------------------------------------------
# K10: the dense march
# ---------------------------------------------------------------------------

def _march_plain(grid: SparseGrid, opt: RenderOptions, origins, dirs, sh_mult, delta_scale,
                 tmin, tmax, n_steps: int, step_chunk: int, depth_sigma_thresh) -> dict:
    """Plain version of K10 (cuvol.py:359-429), ``step_chunk`` samples of
    every ray at a time."""
    B = origins.shape[0]
    dtype, dev = origins.dtype, origins.device
    step = opt.step_size
    bd = grid.basis_dim
    log_T = torch.zeros(B, dtype=dtype, device=dev)
    rgb_acc = torch.zeros((B, 3), dtype=dtype, device=dev)
    depth = torch.zeros(B, dtype=dtype, device=dev)
    t_sig = torch.full((B,), math.inf, dtype=dtype, device=dev)
    ws0 = step * delta_scale
    for k0 in range(0, n_steps, step_chunk):
        ks = torch.arange(k0, k0 + step_chunk, device=dev).to(dtype)
        t = tmin[:, None] + ks[None, :] * step  # (B, V)
        active = t <= tmax[:, None]
        if not bool(active.any()):
            break
        l, frac = voxel_of(origins[:, None, :] + t[..., None] * dirs[:, None, :], grid.reso)
        sigma8, sh8 = _corner_rows(grid, _corner_links(grid, l.permute(2, 0, 1)))
        w8 = trilerp_weights_T(frac.permute(2, 0, 1))  # (8, B, V)
        sigma = _sum0(w8 * sigma8)
        coef = _sum0(w8[..., None] * sh8).reshape(B, -1, 3, bd)  # trilerped SH coefficients
        rgb = _clip(torch.sum(sh_mult[:, None, None, :] * coef, dim=-1) + 0.5, lo=0.0)
        ws = ws0[:, None].expand(-1, step_chunk)
        if opt.last_sample_opaque:
            ws = torch.where(t + step > tmax[:, None], torch.full_like(ws, 1e9), ws)
        la = torch.where(active, -ws * torch.relu(sigma), torch.zeros_like(sigma))
        weight = torch.exp(log_T[:, None] + _excl_cumsum(la)) * (1.0 - torch.exp(la))
        rgb_acc = rgb_acc + torch.sum(weight[..., None] * rgb, dim=1)
        depth = depth + torch.sum(weight * t, dim=1)
        log_T = log_T + torch.sum(la, dim=1)
        if depth_sigma_thresh is not None:
            hit = active & (sigma > depth_sigma_thresh)
            t_sig = torch.minimum(t_sig, torch.where(hit, t, torch.full_like(t, math.inf)).amin(1))
    return {"rgb": rgb_acc, "depth": depth, "log_T": log_T,
            "t_sig": None if depth_sigma_thresh is None else t_sig}


class _MarchChunk(NamedTuple):
    """What K10's forward and backward share besides the parameters."""

    grid: SparseGrid
    opt: RenderOptions
    rays: tuple  # (origins, dirs, sh_mult, delta_scale, tmin, tmax), float32
    n_steps: int
    depth_sigma_thresh: float | None
    bg_rgb: torch.Tensor | None = None  # (B, 3), K13's background colour (detached)


def _k10_args(c: _MarchChunk, density, sh) -> tuple:
    return (*c.rays, c.grid.links, density, sh, c.opt.step_size, c.n_steps,
            c.opt.last_sample_opaque, c.opt.background_brightness)


class _DenseCuvolFn(torch.autograd.Function):
    """K10 forward (with its log_T checkpoints) and backward on the card,
    as ``_PackedCuvolFn`` is K8's: the cotangents of ``rgb``, ``depth`` and
    ``log_T`` into density, SH, the background colour and the basis."""

    @staticmethod
    def forward(ctx, density, sh, bg_rgb, sh_mult, chunk: _MarchChunk):
        m = kernels.cuvol_march(*_k10_args(chunk, density.detach()[:, 0], sh.detach()),
                                chunk.depth_sigma_thresh, bg_rgb=chunk.bg_rgb, checkpoints=True)
        ctx.chunk = chunk
        ctx.save_for_backward(m["log_T"], m["ckpt"])
        ctx.set_materialize_grads(False)
        t_sig = m["t_sig"] if m["t_sig"] is not None else m["depth"].new_zeros(0)
        ctx.mark_non_differentiable(t_sig)
        return m["rgb"], m["depth"], m["log_T"], t_sig

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_log_T, _g_t_sig):
        c = ctx.chunk
        log_T, ckpt = ctx.saved_tensors
        g_rgb, g_depth, g_log_T = _cotangents(g_rgb, g_depth, g_log_T, log_T)
        grid = c.grid
        grads = kernels.cuvol_march_backward(
            *_k10_args(c, grid.density_data.detach()[:, 0], grid.sh_data.detach()), log_T, ckpt,
            g_rgb, g_depth, g_log_T, bg_rgb=c.bg_rgb, want_sh_mult=ctx.needs_input_grad[3])
        return _input_grads(ctx, g_rgb, log_T, grads)


def volume_render_cuvol(
    grid: SparseGrid,
    rays: Rays,
    opt: RenderOptions,
    max_steps: int | None = None,
    depth_sigma_thresh: float | None = None,
    step_chunk: int = 16,
) -> dict:
    """The dense fixed-step march (cuvol.py:297-429): rgb, log_transmit,
    depth, and depth_sigma_thresh (the t of the first sample whose sigma
    exceeds it) when asked. Each ray takes the samples t = tmin + k*step,
    k < ceil(max_steps / step_chunk) * step_chunk, while t <= tmax, as the
    JAX version's scan does. On the card it is K10, and under autograd
    ``_DenseCuvolFn`` (K10 with checkpoints, then K10's backward)."""
    _check_grid(grid)
    if max_steps is None:
        max_steps = max_steps_for(grid, opt)
    n_steps = (max_steps + step_chunk - 1) // step_chunk * step_chunk
    with torch.no_grad():
        origins, dirs, viewdirs, delta_scale, tmin, tmax = _prep_rays(grid, rays, opt)
    sh_mult = eval_basis(grid, viewdirs)
    bg = background_color(grid, opt, origins, dirs, delta_scale)
    if origins.is_cuda:
        bg_rgb = None if bg is None else bg[0]
        chunk = _MarchChunk(grid, opt, tuple(x.detach().contiguous() for x in (
            origins, dirs, sh_mult, delta_scale, tmin, tmax)), n_steps, depth_sigma_thresh,
            None if bg_rgb is None else bg_rgb.detach().contiguous())
        if _wants_grad(grid, bg_rgb, sh_mult):
            rgb, depth, log_T, t_sig = _DenseCuvolFn.apply(grid.density_data, grid.sh_data,
                                                           bg_rgb, sh_mult, chunk)
        else:
            m = kernels.cuvol_march(*_k10_args(chunk, grid.density_data.detach()[:, 0],
                                               grid.sh_data.detach()), depth_sigma_thresh,
                                    bg_rgb=chunk.bg_rgb)
            rgb, depth, log_T, t_sig = m["rgb"], m["depth"], m["log_T"], m["t_sig"]
    else:
        m = _march_plain(grid, opt, origins, dirs, sh_mult, delta_scale, tmin, tmax, n_steps,
                         step_chunk, depth_sigma_thresh)
        rgb = m["rgb"] + torch.exp(m["log_T"])[:, None] * (
            opt.background_brightness if bg is None else bg[0])
        depth, log_T, t_sig = m["depth"], m["log_T"], m["t_sig"]
    if bg is not None:
        log_T = log_T + bg[1]
    out = {"rgb": rgb, "log_transmit": log_T, "depth": depth}
    if depth_sigma_thresh is not None:
        out["depth_sigma_thresh"] = torch.where(torch.isfinite(t_sig), t_sig,
                                                torch.zeros_like(t_sig))
    return out
