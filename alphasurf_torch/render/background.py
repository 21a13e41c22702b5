"""The multi-sphere-image (MSI) background, the counterpart of the JAX
package's ``render.background`` (svox2.py:1353-1441, surf_trav.cu:2914-3139;
``ConcentricSpheresIntersector``, svox2/utils.py:374-418): ``nlayers``
concentric equirect spheres outside the foreground grid, composited behind
it with the transmittance the foreground leaves.

The background's contribution is linear in the foreground's transmittance:
each of its weights is ``exp(log_T_fg + lt) * (1 - exp(log_att))`` and its
final term ``exp(log_T_fg + lt_end) * background_brightness``. So every
renderer takes, per ray, the background colour ``c_bg`` (B, 3) and
``log_T_bg`` (B,) of the spheres rendered from ``log_T = 0``, the brightness
term included, and composites ``rgb = rgb_fg + exp(log_T_fg) * c_bg``,
``log_transmit = log_T_fg + log_T_bg`` (``background_color``): where the
scalar brightness stood, the compositors K4, K8 and K10 read ``c_bg``.

K13 (``csrc/background.cu``) computes ``c_bg`` and ``log_T_bg`` on the card,
one thread a ray, and its backward kernel adds the gradient of
``background_data``; ``render_background`` is the plain version, the JAX
function op for op in its order (the per-ray inner radius, the wrap of u and
v, the int32 truncation, the layer clamp, relu and clip with JAX's
derivatives at their ties, zero rows where a link is -1).
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from ..core.grid import SparseGrid
from ..core.options import RenderOptions

SH_C0 = 0.28209479177387814


def _clip_min0(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, min=0.0): a maximum, which passes half the gradient at
    the tie, as JAX's does."""
    return torch.maximum(x, x.new_zeros(()))


def xyz2equirect(xyz: torch.Tensor, reso: int) -> torch.Tensor:
    """Unit direction -> equirect (u, v) in texels (svox2/utils.py:603)."""
    lat = torch.asin(torch.clamp(xyz[..., 1], -1.0, 1.0))
    lon = torch.atan2(xyz[..., 0], xyz[..., 2])
    u = reso * 2 * (0.5 + lon / (2 * math.pi))
    v = reso * (0.5 - lat / math.pi)
    return torch.stack([u, v], dim=-1)


def n_sphere_steps(grid: SparseGrid, opt: RenderOptions) -> int:
    """Sphere steps a ray takes: int(nlayers / step_size) + 2."""
    return int(grid.background_nlayers / opt.step_size) + 2


def _sphere_geometry(grid: SparseGrid, origins_grid, dirs_grid, delta_scale):
    """The rays in unit-sphere coordinates (ConcentricSpheresIntersector's
    constructor): origins, unit dirs, the world step scale, the quadric's
    coefficients and the per-ray inner radius with its exit ``t_last``."""
    sphere_scaling = 2.0 / grid.gsz
    origins = (origins_grid + 0.5) * sphere_scaling - 1.0
    dirs = dirs_grid * sphere_scaling
    inorm = 1.0 / torch.linalg.norm(dirs, dim=-1)
    world_step_scale = delta_scale * inorm
    dirs = dirs * inorm[..., None]
    q2a = 2 * torch.sum(dirs * dirs, -1)
    qb = 2 * torch.sum(origins * dirs, -1)
    f_det = qb * qb - 2 * q2a * torch.sum(origins * origins, -1)
    inner_radius = torch.clamp(
        torch.linalg.norm(torch.linalg.cross(origins, dirs), dim=-1) + 1e-3, min=1.0)
    det = f_det + 2 * q2a * inner_radius * inner_radius
    t_last = torch.where(det >= 0, (-qb + torch.sqrt(torch.clamp(det, min=0.0))) / q2a,
                         torch.zeros_like(det))
    return origins, dirs, world_step_scale, q2a, qb, f_det, inner_radius, t_last


def sphere_walk(grid: SparseGrid, opt: RenderOptions, origins_grid, dirs_grid, delta_scale):
    """The background's walk of each ray, which does not depend on the rows:
    (world step scale (B,), per step (t, previous t, active, wa, wb), and
    the 8 corners' links and layers (n_steps, 8, B), in JAX's corner order
    v000 .. v111)."""
    nlayers = grid.background_nlayers
    bg_reso = grid.background_reso
    origins, dirs, wss, q2a, qb, f_det, inner_radius, t_last = _sphere_geometry(
        grid, origins_grid, dirs_grid, delta_scale)
    n_steps = n_sphere_steps(grid, opt)
    links = grid.background_links
    geo, lnk_all, lay_all = [], [], []
    tl = t_last
    for i in range(n_steps):
        r = n_steps / (n_steps - i - 0.5)
        det = f_det + 2 * q2a * (r * r)
        ok = det >= 0
        t = torch.where(ok, (-qb + torch.sqrt(torch.clamp(det, min=0.0))) / q2a,
                        torch.zeros_like(det))
        active = ok & (r >= inner_radius)
        t_mid = 0.5 * (t + tl)
        sphpos = origins + t_mid[..., None] * dirs
        invr_mid = 1.0 / torch.linalg.norm(sphpos, dim=-1)
        sphpos = sphpos * invr_mid[..., None]
        xy = xyz2equirect(sphpos, bg_reso)
        z = torch.clamp((1.0 - invr_mid) * nlayers - 0.5, 0.0, nlayers - 1)
        pts = torch.cat([xy, z[..., None]], dim=-1)
        lpt = pts.to(torch.int32)
        lx = torch.clamp(lpt[..., 0], 0, 2 * bg_reso - 1)
        ly = torch.clamp(lpt[..., 1], 0, bg_reso - 1)
        lz = torch.clamp(lpt[..., 2], 0, max(nlayers - 2, 0))
        wb = pts - torch.stack([lx, ly, lz], -1).to(pts.dtype)
        wa = 1.0 - wb
        lnx = (lx + 1) % (2 * bg_reso)
        lny = (ly + 1) % bg_reso
        # lz + 1 reads out of range at nlayers == 1, where JAX's gather
        # clamps the index to the last layer
        lnz = torch.clamp(lz + 1, max=nlayers - 1)
        lnk_all.append(torch.stack([links[x, y].long() for x in (lx, lnx) for y in (ly, lny)
                                    for _ in (0, 1)], 0))
        lay_all.append(torch.stack([lz, lnz] * 4, 0).long())
        geo.append((t, tl, active, wa, wb))
        tl = torch.where(active, t, tl)
    return wss, geo, torch.stack(lnk_all, 0), torch.stack(lay_all, 0)


def render_background(grid: SparseGrid, opt: RenderOptions, origins_grid, dirs_grid,
                      delta_scale, log_T, rgb_acc):
    """Plain version of K13: the JAX package's ``render_background``
    (background.py:32-134), composite the MSI behind the foreground. Rays
    in grid coordinates with unit dirs, their grid->world step scale, the
    foreground's remaining ``log_T`` (B,) and accumulated ``rgb_acc``
    (B, 3). Returns (rgb_acc, log_T) updated. Differentiable in
    ``background_data`` (and in ``log_T`` and ``rgb_acc``) by autograd.

    The walk does not depend on the rows (``sphere_walk``), so all 8
    corners of every step are gathered at once: the gather's backward is
    then one scatter into a gradient of the background's size, not one a
    step. The arithmetic is JAX's, step by step in its order."""
    wss, geo, lnk, lay = sphere_walk(grid, opt, origins_grid, dirs_grid, delta_scale)
    data = grid.background_data  # (n, nlayers, 4)
    safe = torch.clamp(lnk, 0, data.shape[0] - 1)
    vals = data.reshape(-1, 4)[safe * grid.background_nlayers + lay]
    vals = vals * (lnk >= 0)[..., None].to(vals.dtype)  # fetch: zero where a link is -1

    rgb = rgb_acc
    lt = log_T
    for i, (t, tl, active, wa, wb) in enumerate(geo):
        v000, v001, v010, v011, v100, v101, v110, v111 = vals[i]
        c00 = v000 * wa[:, 2:] + v001 * wb[:, 2:]
        c01 = v010 * wa[:, 2:] + v011 * wb[:, 2:]
        c10 = v100 * wa[:, 2:] + v101 * wb[:, 2:]
        c11 = v110 * wa[:, 2:] + v111 * wb[:, 2:]
        c0 = c00 * wa[:, 1:2] + c01 * wb[:, 1:2]
        c1 = c10 * wa[:, 1:2] + c11 * wb[:, 1:2]
        rgba = c0 * wa[:, :1] + c1 * wb[:, :1]
        log_att = torch.where(active, -wss * torch.relu(rgba[:, -1]) * (t - tl),
                              torch.zeros_like(t))
        weight = torch.exp(lt) * (1.0 - torch.exp(log_att))
        col = _clip_min0(rgba[:, :3] * SH_C0 + 0.5)
        rgb = rgb + torch.where(active[..., None], col * weight[..., None],
                                torch.zeros_like(col))
        lt = lt + log_att
    return rgb, lt


def _background_plain(grid, opt, origins, dirs, delta_scale):
    zero = torch.zeros_like(delta_scale)
    rgb, lt = render_background(grid, opt, origins, dirs, delta_scale, zero,
                                torch.zeros_like(origins))
    return rgb + torch.exp(lt)[:, None] * opt.background_brightness, lt


def _k13_args(grid: SparseGrid, opt: RenderOptions, origins, dirs, delta_scale) -> tuple:
    return (origins.contiguous(), dirs.contiguous(), delta_scale.contiguous(),
            grid.reso, grid.background_links, n_sphere_steps(grid, opt),
            float(opt.background_brightness))


class _BackgroundFn(torch.autograd.Function):
    """K13 forward, and K13's backward kernel for the gradient of
    ``background_data`` from the cotangents of ``c_bg`` and ``log_T_bg``."""

    @staticmethod
    def forward(ctx, data, args: tuple):
        c, lt = kernels.background_forward(*args, data.detach())
        ctx.args = args
        ctx.save_for_backward(data, lt)
        ctx.set_materialize_grads(False)
        return c, lt

    @staticmethod
    def backward(ctx, g_c, g_lt):
        data, lt = ctx.saved_tensors
        B = lt.shape[0]
        g_c = lt.new_zeros((B, 3)) if g_c is None else g_c.contiguous()
        g_lt = lt.new_zeros(B) if g_lt is None else g_lt.contiguous()
        return kernels.background_backward(*ctx.args, data.detach(), lt, g_c, g_lt), None


def background_color(grid: SparseGrid, opt: RenderOptions, origins, dirs, delta_scale):
    """Per ray, the background colour ``c_bg`` (B, 3), the brightness
    term ``exp(log_T_bg) * background_brightness`` included, and
    ``log_T_bg`` (B,), from grid-space rays with unit dirs and their
    grid->world step scale; None without a background. On the card K13,
    whose backward kernel carries the gradient of ``background_data``; on
    the CPU the plain version, differentiated by autograd."""
    if not grid.use_background:
        return None
    if not origins.is_cuda:
        return _background_plain(grid, opt, origins, dirs, delta_scale)
    args = _k13_args(grid, opt, origins, dirs, delta_scale)
    data = grid.background_data
    if torch.is_grad_enabled() and data.requires_grad:
        return _BackgroundFn.apply(data, args)
    return kernels.background_forward(*args, data.detach())
