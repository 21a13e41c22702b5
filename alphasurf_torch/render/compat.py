"""The compat renderer backends "nvol" and "svox1", the counterpart of the
JAX package's ``render.compat`` (svox2's secondary backends):

* ``volume_render_nvol``: Neural-Volumes-style additive alpha
  (render_lerp_kernel_nvol.cu:48-105): ``total += 1 - exp(-ws sigma)``
  clamped at 1, each sample weighted by the clamped increment, the
  background by ``1 - total``;
* ``volume_render_svox1``: PlenOctrees/svox1 nearest-neighbour sampling
  (the origin shifted by +0.5 and truncated, render_svox1_kernel.cu:77-110)
  with exponential transmittance.

Both are fixed-step marches of ``RenderOptions.step_size`` (JAX's
deviation from the reference's cell-boundary walk, kept): on the card K14
(``csrc/compat.cu``, one thread a ray, forward and backward), on the CPU
the plain versions below, the JAX scan's steps op for op. ``_CompatFn``
carries the cotangents of ``rgb``, ``depth`` and ``alpha`` /
``log_transmit`` into density, SH and the per-ray basis (K14's
``compat_backward_out`` when depth or acc takes one). ``volume_render``
dispatches the five backends by name, as the JAX package's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import kernels
from ..core.grid import SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Rays
from ..core.sh import eval_basis
from ..ops.trilerp import trilerp_weights_T, voxel_of
from .cuvol import _corner_links, _corner_rows, max_steps_for
from .surface import _clip, _sum0


def _march_setup(grid: SparseGrid, rays: Rays, nn_offset: bool):
    """Grid-space origins (+0.5 for svox1's nearest neighbour), unit
    grid-space directions, the world step scale, the rays' basis and the
    march bounds (compat.py:35-55). The basis is evaluated under autograd,
    the rest without."""
    with torch.no_grad():
        origins = grid.world2grid(rays.origins)
        if nn_offset:
            origins = origins + 0.5  # nn-vs-lerp offset (svox1 kernel :77)
        viewdirs = rays.dirs / torch.linalg.norm(rays.dirs, dim=-1, keepdim=True)
        gsz = grid.gsz
        dirs = viewdirs * (grid.scaling * gsz)
        delta_scale = 1.0 / torch.linalg.norm(dirs, dim=-1)
        dirs = dirs * delta_scale[..., None]
        safe_dirs = torch.where(dirs == 0, torch.full_like(dirs, 1e-12), dirs)
        lo = 0.0 if nn_offset else -0.5
        hi_off = -1.0 if nn_offset else -0.5
        t1 = (lo - origins) / safe_dirs
        t2 = (gsz + hi_off - origins) / safe_dirs
        tmin = torch.where(dirs == 0, torch.full_like(t1, -1e9), torch.minimum(t1, t2))
        tmin = torch.clamp(torch.amax(tmin, dim=-1), min=0.0)
        tmaxs = torch.where(dirs == 0, torch.full_like(t1, 1e9), torch.maximum(t1, t2))
        tmax = torch.amin(tmaxs, dim=-1)
    sh_mult = eval_basis(grid, viewdirs)
    return origins, dirs, delta_scale, sh_mult, tmin, tmax


def _colour(sh_mult, rgb_sh, bd: int):
    """max(sum_b sh_mult * coefficients + 0.5, 0) per channel: (B, 3)."""
    rgb_sh = rgb_sh.reshape(rgb_sh.shape[0], 3, bd)
    return _clip(torch.sum(sh_mult[:, None, :] * rgb_sh, -1) + 0.5, lo=0.0)


def _run_steps(step, carry, max_steps, tmin, tmax, step_size):
    """The scan of a plain march: ``carry = step(t, active, *carry)`` for
    t = tmin + k step_size, k < max_steps, until no ray is active (t rises
    with k, so every later step adds 0). Under autograd each step is
    checkpointed, as the JAX package's ``jax.checkpoint`` on its scan body:
    its samples are recomputed in the backward instead of kept."""
    dtype, dev = tmin.dtype, tmin.device
    grad = torch.is_grad_enabled()
    for k in range(max_steps):
        t = tmin + torch.tensor(float(k), dtype=dtype, device=dev) * step_size
        active = t <= tmax
        if not bool(active.any()):
            break
        if grad:
            carry = checkpoint(step, t, active, *carry, use_reentrant=False)
        else:
            carry = step(t, active, *carry)
    return carry


def _nvol_plain(grid, opt, origins, dirs, delta_scale, sh_mult, tmin, tmax, max_steps):
    """The plain version of K14's nvol march (compat.py:70-112): rgb
    (without the background), depth and the total alpha."""
    B = origins.shape[0]
    dtype, dev = origins.dtype, origins.device
    one = torch.ones((), dtype=dtype, device=dev)

    def step(t, active, total, rgb_acc, depth):
        l, frac = voxel_of(origins + t[:, None] * dirs, grid.reso)
        sigma8, sh8 = _corner_rows(grid, _corner_links(grid, l.T))  # (8, B), (8, B, 3 bd)
        w8 = trilerp_weights_T(frac.T)  # (8, B)
        sigma = _sum0(w8 * sigma8)
        rgb_sh = _sum0(w8[..., None] * sh8)
        use = active & (sigma > opt.sigma_thresh)
        inc = torch.where(use, 1.0 - torch.exp(-opt.step_size * delta_scale * torch.relu(sigma)),
                          torch.zeros_like(sigma))
        new_total = torch.minimum(total + inc, one)
        weight = new_total - total
        rgb_acc = rgb_acc + weight[:, None] * _colour(sh_mult, rgb_sh, grid.basis_dim)
        return new_total, rgb_acc, depth + weight * t

    zero = torch.zeros(B, dtype=dtype, device=dev)
    total, rgb_acc, depth = _run_steps(step, (zero, torch.zeros((B, 3), dtype=dtype, device=dev),
                                              zero), max_steps, tmin, tmax, opt.step_size)
    return rgb_acc, depth, total


def _svox1_plain(grid, opt, origins, dirs, delta_scale, sh_mult, tmin, tmax, max_steps):
    """The plain version of K14's svox1 march (compat.py:127-156): rgb
    (without the background), depth and log_T."""
    B = origins.shape[0]
    dtype, dev = origins.dtype, origins.device
    X, Y, Z = grid.reso
    flat_links = grid.links.reshape(-1)

    def step(t, active, log_T, rgb_acc, depth):
        pos = origins + t[:, None] * dirs
        lx = torch.clamp(pos[:, 0].to(torch.int32), 0, X - 1).long()
        ly = torch.clamp(pos[:, 1].to(torch.int32), 0, Y - 1).long()
        lz = torch.clamp(pos[:, 2].to(torch.int32), 0, Z - 1).long()
        sigma, rgb_sh = _corner_rows(grid, flat_links[(lx * Y + ly) * Z + lz])
        use = active & (sigma > opt.sigma_thresh)
        log_att = torch.where(use, -opt.step_size * delta_scale * torch.relu(sigma),
                              torch.zeros_like(sigma))
        weight = torch.exp(log_T) * (1.0 - torch.exp(log_att))
        rgb_acc = rgb_acc + weight[:, None] * _colour(sh_mult, rgb_sh, grid.basis_dim)
        return log_T + log_att, rgb_acc, depth + weight * t

    zero = torch.zeros(B, dtype=dtype, device=dev)
    log_T, rgb_acc, depth = _run_steps(step, (zero, torch.zeros((B, 3), dtype=dtype, device=dev),
                                              zero), max_steps, tmin, tmax, opt.step_size)
    return rgb_acc, depth, log_T


class _Compat(NamedTuple):
    """What a K14 launch shares besides the parameters."""

    mode: str
    grid: SparseGrid
    opt: RenderOptions
    rays: tuple  # (origins, dirs, sh_mult, delta_scale, tmin, tmax), float32, detached
    max_steps: int


def _k14_args(c: _Compat, density, sh) -> tuple:
    return (c.mode, *c.rays, c.grid.links, density, sh, c.opt.step_size, c.max_steps,
            c.opt.sigma_thresh, c.opt.background_brightness)


class _CompatFn(torch.autograd.Function):
    """K14 forward and backward on the card: ``rgb``, ``depth`` and ``acc``
    (total alpha or log_T) carry the gradient to density, SH and the per-ray
    basis ``sh_mult``."""

    @staticmethod
    def forward(ctx, density, sh, sh_mult, c: _Compat):
        out = kernels.compat_forward(*_k14_args(c, density.detach()[:, 0], sh.detach()))
        ctx.c = c
        ctx.set_materialize_grads(False)
        return out["rgb"], out["depth"], out["acc"]

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        c = ctx.c
        B = c.rays[0].shape[0]
        if g_rgb is None:
            g_rgb = torch.zeros((B, 3), dtype=torch.float32, device=c.rays[0].device)
        need = ctx.needs_input_grad
        g_density, g_sh, *g_shm = kernels.compat_backward(
            *_k14_args(c, c.grid.density_data.detach()[:, 0], c.grid.sh_data.detach()),
            g_rgb.contiguous(), want_sh_mult=need[2],
            g_depth=None if g_depth is None else g_depth.contiguous(),
            g_acc=None if g_acc is None else g_acc.contiguous())
        return (g_density[:, None] if need[0] else None, g_sh if need[1] else None,
                g_shm[0] if need[2] else None, None)


def _march(mode: str, grid: SparseGrid, rays: Rays, opt: RenderOptions, max_steps):
    if max_steps is None:
        max_steps = max_steps_for(grid, opt)
    origins, dirs, delta_scale, sh_mult, tmin, tmax = _march_setup(grid, rays, mode == "svox1")
    if not origins.is_cuda:
        fn = _nvol_plain if mode == "nvol" else _svox1_plain
        rgb_acc, depth, acc = fn(grid, opt, origins, dirs, delta_scale, sh_mult, tmin, tmax,
                                 max_steps)
        bgw = (1.0 - acc) if mode == "nvol" else torch.exp(acc)
        return rgb_acc + bgw[:, None] * opt.background_brightness, depth, acc
    c = _Compat(mode, grid, opt, tuple(x.detach().contiguous() for x in (
        origins, dirs, sh_mult, delta_scale, tmin, tmax)), int(max_steps))
    if torch.is_grad_enabled() and (grid.density_data.requires_grad or grid.sh_data.requires_grad
                                    or sh_mult.requires_grad):
        return _CompatFn.apply(grid.density_data, grid.sh_data, sh_mult, c)
    out = kernels.compat_forward(*_k14_args(c, grid.density_data.detach()[:, 0],
                                            grid.sh_data.detach()))
    return out["rgb"], out["depth"], out["acc"]


def volume_render_nvol(grid: SparseGrid, rays: Rays, opt: RenderOptions,
                       max_steps: int | None = None) -> dict:
    """The additive-alpha ("neural volumes") backend (compat.py:58): rgb,
    alpha (the total), depth and log_transmit = log(max(1 - alpha, 1e-10)).
    ``max_steps`` defaults to ``max_steps_for``."""
    rgb, depth, total = _march("nvol", grid, rays, opt, max_steps)
    return {"rgb": rgb, "alpha": total, "depth": depth,
            "log_transmit": torch.log(torch.clamp(1.0 - total, min=1e-10))}


def volume_render_svox1(grid: SparseGrid, rays: Rays, opt: RenderOptions,
                        max_steps: int | None = None) -> dict:
    """The nearest-neighbour (PlenOctrees) backend (compat.py:115): rgb,
    log_transmit and depth."""
    rgb, depth, log_T = _march("svox1", grid, rays, opt, max_steps)
    return {"rgb": rgb, "log_transmit": log_T, "depth": depth}


BACKENDS = {
    "nvol": volume_render_nvol,
    "svox1": volume_render_svox1,
}


def volume_render(grid: SparseGrid, rays: Rays, opt: RenderOptions, backend: str, **kwargs):
    """Backend dispatch by name (compat.py:174-190; svox2.py:3390-3475):
    "cuvol" (the dense march), "nvol", "svox1", "surface" (the dense
    surface walk) and "surf_trav" (the K-slot compact renderer)."""
    from .cuvol import volume_render_cuvol
    from .surface import volume_render_surface, volume_render_surface_compact

    table = {
        "cuvol": volume_render_cuvol,
        "nvol": volume_render_nvol,
        "svox1": volume_render_svox1,
        "surface": volume_render_surface,
        "surf_trav": volume_render_surface_compact,
    }
    if backend not in table:
        raise ValueError(f"unknown backend {backend!r} (have {sorted(table)})")
    return table[backend](grid, rays, opt, **kwargs)
