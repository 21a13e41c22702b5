"""The train steps, the counterparts of the JAX package's
``train.steps.make_surface_step`` (steps.py:222-444; svox2's opt.py:786-1152)
and ``make_cuvol_step`` (steps.py:447-536, the Plenoxels warm start).

A surface step renders the batch through the renderer ``StepConfig.renderer``
names (packed, compact or dense: K1-K4 and K11a/K11b forward, K5 backward on
the card), adds the streaming ray losses, the two-pass losses on the first-K
sample cache (``use_two_pass_losses``, K11c/K11d), the cell-sampled
regularizers (K6) and the extended surface regularizers its flags turn on
(``use_eikonal``, ``use_norm_match``, ``use_viscosity``,
``use_sign_change``: K12a-K12d), and applies masked RMSprop (K7) to
density, SH, surface and fake_sample_std, in place. A cuvol step renders through the
packed cuvol renderer (K8 forward and backward over K2's pool) or, when it is
not packed or has no occupancy, the dense march (K10 and its backward), adds the TV
of density and SH (K6) and applies K7 to density and SH. Both steps render
a grid's MSI background through K13 and, when the rms state holds a
"background" group, train it (the JAX package's aux group): the background
TV (K12f) and, with ``use_lumisphere_tv``, the SH colours' lumisphere TV
(K12e) join the loss, and K7 steps the background's (link, layer) rows. On
the card each makes one host sync, the one that sizes K2's pool. Both steps
train a learned basis when the rms state holds its group (JAX's aux groups
"basis_data" and "basis_mlp"): the renderer's per-ray basis carries the
gradient (K5b's and K8's ``sh_mult`` output), the texture's TV (K12g)
joins the loss at ``lambda_tv_basis``, and K7 steps the texture's cells,
each weight matrix's rows and each bias as one row at ``lr_basis``. Per-step
scalars come in ``HParams`` as Python floats; a term whose weight is 0 is
computed all the same, as the JAX step does, except ``l2_color_loss`` (a
full pass over the SH rows for nothing) and the background TV with both of
its weights 0 (a pass over the background's cells for nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.grid import SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Rays
from ..losses import reg
from ..losses import render_losses as rl
from ..optim.rmsprop import rmsprop_init, rmsprop_step
from ..render.cuvol import volume_render_cuvol, volume_render_cuvol_packed
from ..render.surface import (
    RENDERERS, volume_render_surface, volume_render_surface_compact,
    volume_render_surface_packed,
)


class HParams(NamedTuple):
    """Per-step scalars, the JAX package's ``HParams`` field for field."""

    lr_sigma: float = 0.0
    lr_alpha: float = 0.0
    lr_surface: float = 0.0
    lr_sh: float = 0.0
    lr_fake_sample_std: float = 0.0
    img_lambda_l1_ratio: float = 0.0
    lambda_tv: float = 0.0
    lambda_tv_sh: float = 0.0
    lambda_tv_alpha: float = 0.0
    lambda_tv_surface: float = 0.0
    lambda_normal_l1: float = 0.0
    lambda_normal_l2: float = 0.0
    lambda_sparsify_alpha: float = 0.0
    lambda_sparsify_surf: float = 0.0
    lambda_l_dist: float = 0.0
    lambda_l_dist_a: float = 0.0
    lambda_l_entropy: float = 0.0
    lambda_l_entropy_a: float = 0.0
    lambda_conv_mode_samp: float = 0.0
    lambda_samp_dist: float = 0.0
    lambda_sparsity: float = 0.0
    lambda_eikonal: float = 0.0
    lambda_inward_norm: float = 0.0
    lambda_density_lap: float = 0.0
    lambda_udf_var: float = 0.0
    lambda_fs_std_l1: float = 0.0
    lambda_fs_std_l2: float = 0.0
    surface_unfrozen: float = 1.0  # 0 during surface_init_freeze
    force_apply: float = 0.0
    lr_basis: float = 0.0
    lr_background: float = 0.0
    lambda_tv_background: float = 0.0
    lambda_tv_background_density: float = 0.0
    lambda_tv_basis: float = 0.0
    lambda_l2_color: float = 0.0
    lambda_norm_match: float = 0.0
    lambda_viscosity: float = 0.0
    lambda_sign_change: float = 0.0
    lambda_tv_lumisphere: float = 0.0


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX package's ``StepConfig`` field for field. The port's pool is
    exact, so ``entries_per_ray``, ``coarse_factor`` and ``supers_per_ray``
    (the JAX pool's budget) are accepted and not needed. ``max_voxels``
    reaches the dense walk, ``max_intersect_voxels`` and ``voxel_chunk`` the
    compact renderer; ``max_steps`` the dense cuvol march of a cuvol step
    that is not packed."""

    opt: RenderOptions
    max_voxels: Optional[int] = None
    max_steps: Optional[int] = None
    cache_size: Optional[int] = 64
    tv_sparsity: float = 0.01
    tv_sh_sparsity: float = 0.01
    tv_surface_sparsity: float = 0.01
    norm_surface_sparsity: float = 0.01
    sparsify_sparsity: float = 0.01
    norm_con_check: bool = False
    norm_ignore_empty: bool = False
    sparsify_surf_decrease: bool = True
    sparsify_surf_thresh: float = 0.15
    surf_tv_alpha_weighted: bool = False
    rms_beta: float = 0.95
    bg_sparsity: float = 0.01
    lumisphere_sparsity: float = 0.01
    viscosity_eta: float = 1e-2
    use_eikonal: bool = False
    use_norm_match: bool = False
    use_viscosity: bool = False
    use_sign_change: bool = False
    use_lumisphere_tv: bool = False
    use_two_pass_losses: bool = False
    renderer: str = "packed"
    surf_grad_abs_max: Optional[float] = None
    max_intersect_voxels: int = 64
    voxel_chunk: int = 8
    entries_per_ray: float = 8.0
    coarse_factor: int = 8
    supers_per_ray: float = 8.0
    axis_name: Optional[str] = None


# the sampled windows of one step, named as ``window_starts`` keys; "normal"
# is also the window of the extended terms K12a, K12b and K12d, and
# "sign_change" that of K12c (JAX's k_ext, steps.py:348); "lumisphere" the
# lattice window of K12e (drawn only with use_lumisphere_tv)
WINDOWS = ("tv", "tv_sh", "tv_surface", "normal", "sparsify", "sign_change", "lumisphere")
# the StepConfig switches of the extended surface regularizers
EXT_FLAGS = ("use_eikonal", "use_norm_match", "use_viscosity", "use_sign_change")
CUVOL_WINDOWS = ("tv", "tv_sh", "lumisphere")
_PARAMS = (("density", "density_data"), ("sh", "sh_data"), ("surface", "surface_data"),
           ("fake_sample_std", "fake_sample_std"), ("background", "background_data"),
           ("basis_data", "basis_data"))
# the learned MLP basis's group: a dict of its four tensors, as JAX's
MLP_GROUP = "basis_mlp"


def _mlp_tensors(grid: SparseGrid) -> dict:
    return {} if grid.basis_mlp is None else grid.basis_mlp.tensors()


def init_rms(grid: SparseGrid) -> dict:
    """Zero rms state of each trained group, keyed as the JAX ``init_rms``
    (the background's "background", the texture's "basis_data" and the
    MLP's "basis_mlp", a dict of w0, b0, w1, b1, included)."""
    rms = {k: rmsprop_init(getattr(grid, f)) for k, f in _PARAMS if getattr(grid, f) is not None}
    if grid.basis_mlp is not None:
        rms[MLP_GROUP] = {k: rmsprop_init(v) for k, v in _mlp_tensors(grid).items()}
    return rms


def _map_state(fn, rms: dict) -> dict:
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict) else fn(v))
            for k, v in rms.items()}


def rms_to_numpy(rms: dict) -> dict:
    """numpy arrays of an rms state, JAX's nested key names kept."""
    return _map_state(lambda v: v.detach().cpu().numpy(), rms)


def rms_from_numpy(arrays: dict, device="cuda", dtype=None) -> dict:
    """An rms state from numpy arrays keyed as the JAX ``init_rms`` dict
    (for a JAX state: ``{k: np.asarray(v.rms)}``, and for its "basis_mlp"
    a dict of the four tensors' states)."""
    dev = resolve_device(device)
    return _map_state(lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=dev), arrays)


@contextlib.contextmanager
def _requires_grad(params):
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _check_config(cfg: StepConfig) -> None:
    """Raise on what the port's steps do not carry."""
    if cfg.renderer not in RENDERERS:
        raise ValueError(f"renderer {cfg.renderer!r}; one of {RENDERERS}")
    if cfg.axis_name is not None:
        raise NotImplementedError("data-parallel steps (axis_name) are not ported yet "
                                  "(ROADMAP §1 item 3)")


def _check_rms(rms: dict) -> None:
    extra = set(rms) - {k for k, _ in _PARAMS} - {MLP_GROUP}
    if extra:
        raise ValueError(f"unknown rms groups {sorted(extra)}")


def _trained(grid: SparseGrid, rms: dict) -> dict:
    """The parameters a step trains: each group of ``rms`` whose grid field
    exists (the background and the learned bases, like JAX's aux groups,
    only then); the MLP's tensors as "basis_mlp.w0" ..."""
    out = {k: getattr(grid, f) for k, f in _PARAMS if k in rms and getattr(grid, f) is not None}
    if MLP_GROUP in rms:
        out.update({f"{MLP_GROUP}.{k}": v for k, v in _mlp_tensors(grid).items()})
    return out


def _aux_reg_losses(grid: SparseGrid, hp: HParams, cfg: StepConfig, generator, starts):
    """The regularizers both stages add (steps.py:177-194): the L2 of the
    SH colours, the learned texture's TV (K12g), the background TV (K12f)
    over ``bg_sparsity`` of its cells drawn with replacement, and with
    ``use_lumisphere_tv`` the lumisphere TV (K12e) over the "lumisphere"
    lattice window along a drawn direction."""
    loss = 0.0
    if hp.lambda_l2_color != 0.0:
        loss = loss + hp.lambda_l2_color * reg.l2_color_loss(grid)
    if grid.basis_data is not None:
        loss = loss + hp.lambda_tv_basis * reg.basis_tv_loss(grid)
    if grid.background_data is not None and (hp.lambda_tv_background != 0.0
                                             or hp.lambda_tv_background_density != 0.0):
        cells_bg = reg.sample_background_cells(generator, grid, cfg.bg_sparsity)
        loss = loss + reg.background_tv_loss(grid, cells_bg, hp.lambda_tv_background,
                                             hp.lambda_tv_background_density)
    if cfg.use_lumisphere_tv:
        cells = reg.sample_cells(generator, grid, cfg.lumisphere_sparsity, starts.get("lumisphere"))
        loss = loss + hp.lambda_tv_lumisphere * reg.lumisphere_tv_loss(grid, cells, generator)
    return loss


def _step_background(grid: SparseGrid, rms: dict, g: dict, hp: HParams, beta: float) -> None:
    """K7 on the background group, its (link, layer) rows of 4 channels
    each (``_aux_optim``, steps.py:214-218)."""
    if "background" in g:
        rmsprop_step(grid.background_data.view(-1, 4), rms["background"].view(-1, 4),
                     g["background"].reshape(-1, 4), hp.lr_background, beta)


def _step_basis(grid: SparseGrid, rms: dict, g: dict, hp: HParams, beta: float) -> None:
    """K7 on the learned bases' groups at ``lr_basis`` (``_aux_optim``,
    steps.py:200-213), with JAX's mask any(grad != 0, axis=-1): the
    texture's (R^3, bd) cells, each weight matrix's rows, and each 1-D bias
    as one whole row (1, n), so that a bias whose gradient is zero but for
    one unit still steps (and decays the rms of) every unit."""
    if "basis_data" in g:
        bd = grid.basis_data.shape[-1]
        rmsprop_step(grid.basis_data.view(-1, bd), rms["basis_data"].view(-1, bd),
                     g["basis_data"].reshape(-1, bd), hp.lr_basis, beta)
    for k, v in _mlp_tensors(grid).items():
        name = f"{MLP_GROUP}.{k}"
        if name in g:
            shape = (1, -1) if v.dim() == 1 else tuple(v.shape)
            rmsprop_step(v.view(shape), rms[MLP_GROUP][k].view(shape), g[name].reshape(shape),
                         hp.lr_basis, beta)


def _window_starts(window_starts, names) -> dict:
    starts = dict(window_starts or {})
    if set(starts) - set(names):
        raise ValueError(f"unknown windows {sorted(set(starts) - set(names))}; known: {names}")
    return starts


def _sampler(generator, grid, row_coords, starts):
    """(reg_scale, sample(name, frac)): present-cell windows with
    ``row_coords``, lattice windows without (steps.py:237-243)."""
    if row_coords is not None:
        def sample(name, frac):
            return reg.sample_present_cells(generator, grid, row_coords, frac, starts.get(name))

        return reg.present_norm_scale(grid), sample

    def sample(name, frac):
        return reg.sample_cells(generator, grid, frac, starts.get(name))

    return 1.0, sample


def make_surface_step(cfg: StepConfig):
    """The surface-stage train step, as the JAX package's (steps.py:222-444).

    ``step(grid, rms, rays, rgb_gt, hp, generator, occ=None, row_coords=None,
    window_starts=None) -> (grid, rms, stats)`` updates ``grid``'s
    parameters and ``rms`` in place and returns them with ``stats`` (loss,
    mse, pool_overflow: tensors). ``generator`` (a CPU ``torch.Generator``)
    draws the regularizer windows; ``window_starts`` may fix any of them by
    name (``WINDOWS``). ``occ`` are the occupancy words of
    ``render.surface.occupancy_words``; ``row_coords`` (``reg.row_coords_of``)
    switches the regularizers to present-cell windows, and to the full
    lattice for a sparsity >= 0.5.

    The extended terms (``EXT_FLAGS``) take the "normal" window, as JAX's
    take its ``cells_n``, and K12c its own "sign_change" window, drawn after
    "sparsify". In the dense branch (``row_coords`` given and
    ``norm_surface_sparsity`` >= 0.5) the normal losses need no window, and
    the step draws "normal" there only when one of the four flags is on, so
    that a run with the flags off keeps the window sequence of its
    generator."""
    _check_config(cfg)

    def step(grid: SparseGrid, rms: dict, rays: Rays, rgb_gt: torch.Tensor, hp: HParams,
             generator: torch.Generator, occ=None, row_coords=None, window_starts=None):
        _check_rms(rms)
        starts = _window_starts(window_starts, WINDOWS)
        reg_scale, sample = _sampler(generator, grid, row_coords, starts)
        ext = any(getattr(cfg, f) for f in EXT_FLAGS)
        params = _trained(grid, rms)
        cache = cfg.cache_size if cfg.use_two_pass_losses else None
        with _requires_grad(list(params.values())):
            if cfg.renderer == "packed":
                out = volume_render_surface_packed(grid, rays, cfg.opt, cache_size=cache,
                                                   occupancy=occ)
            elif cfg.renderer == "compact":
                out = volume_render_surface_compact(
                    grid, rays, cfg.opt, max_intersect_voxels=cfg.max_intersect_voxels,
                    cache_size=cache, voxel_chunk=cfg.voxel_chunk, occupancy=occ)
            else:
                # the JAX dense step walks every voxel, stale occupancy or
                # not: K11a keeps the voxels of words made fresh this step
                out = volume_render_surface(grid, rays, cfg.opt, max_voxels=cfg.max_voxels,
                                            cache_size=cache)
            resid = out["rgb"] - rgb_gt
            if rays.masks is not None:
                resid = resid * rays.masks[:, None]
            mse = torch.mean(resid ** 2)
            l1r = hp.img_lambda_l1_ratio
            loss = (1.0 - l1r) * mse + l1r * torch.mean(torch.abs(resid))

            ray_l = out["ray_losses"]
            loss = loss + hp.lambda_l_dist * rl.l_dist_from_ray_losses(ray_l, alphas=False)
            loss = loss + hp.lambda_l_dist_a * rl.l_dist_from_ray_losses(ray_l, alphas=True)
            loss = loss + hp.lambda_l_entropy * rl.l_entropy_from_ray_losses(ray_l, alphas=False)
            loss = loss + hp.lambda_l_entropy_a * rl.l_entropy_from_ray_losses(ray_l, alphas=True)
            loss = loss + hp.lambda_sparsity * rl.l_sparsity_from_ray_losses(ray_l)
            loss = loss + hp.lambda_inward_norm * rl.l_inward_norm_from_ray_losses(ray_l)
            loss = loss + hp.lambda_density_lap * rl.density_lap_from_ray_losses(ray_l)
            loss = loss + hp.lambda_udf_var * rl.udf_var_from_ray_losses(ray_l)
            if cache is not None:
                loss = loss + hp.lambda_conv_mode_samp * rl.l_conv_mode_samp_from_cache(
                    out["cache"])
                loss = loss + hp.lambda_samp_dist * rl.l_samp_dist_from_cache(out["cache"])

            # cell-sampled regularizers (opt.py:939-1074)
            cells = sample("tv", cfg.tv_sparsity)
            loss = loss + reg_scale * hp.lambda_tv_alpha * reg.tv_loss(grid, grid.density_data,
                                                                       cells)
            cells = sample("tv_sh", cfg.tv_sh_sparsity)
            loss = loss + reg_scale * hp.lambda_tv_sh * reg.tv_loss(grid, grid.sh_data, cells)
            dense_ok = row_coords is not None
            if dense_ok and cfg.tv_surface_sparsity >= 0.5:
                loss = loss + hp.lambda_tv_surface * reg.surface_tv_loss_dense(
                    grid, row_coords, alpha_weighted=cfg.surf_tv_alpha_weighted)
            else:
                cells = sample("tv_surface", cfg.tv_surface_sparsity)
                loss = loss + reg_scale * hp.lambda_tv_surface * reg.surface_tv_loss(
                    grid, cells, alpha_weighted=cfg.surf_tv_alpha_weighted)
            con, empty = cfg.norm_con_check, cfg.norm_ignore_empty
            cells_n = None
            if dense_ok and cfg.norm_surface_sparsity >= 0.5:
                loss = loss + hp.lambda_normal_l1 * reg.surface_normal_loss_dense(
                    grid, row_coords, con, empty, use_l1=True)
                loss = loss + hp.lambda_normal_l2 * reg.surface_normal_loss_dense(
                    grid, row_coords, con, empty, use_l1=False)
                if ext:
                    cells_n = sample("normal", cfg.norm_surface_sparsity)
            else:
                cells_n = sample("normal", cfg.norm_surface_sparsity)
                loss = loss + reg_scale * hp.lambda_normal_l1 * reg.surface_normal_loss(
                    grid, cells_n, con, empty, use_l1=True)
                loss = loss + reg_scale * hp.lambda_normal_l2 * reg.surface_normal_loss(
                    grid, cells_n, con, empty, use_l1=False)
            cells = sample("sparsify", cfg.sparsify_sparsity)
            loss = loss + reg_scale * reg.alpha_surf_sparsify_loss(
                grid, cells, hp.lambda_sparsify_alpha, hp.lambda_sparsify_surf,
                cfg.sparsify_surf_decrease, cfg.sparsify_surf_thresh)
            # the extended surface regularizers (steps.py:334-349)
            if cfg.use_eikonal:
                loss = loss + reg_scale * hp.lambda_eikonal * reg.surface_eikonal_loss(
                    grid, cells_n)
            if cfg.use_norm_match:
                loss = loss + reg_scale * hp.lambda_norm_match * reg.surface_norm_match_loss(
                    grid, cells_n)
            if cfg.use_viscosity:
                h = 2.0 * torch.mean(grid.radius) / torch.mean(grid.gsz)
                loss = loss + reg_scale * hp.lambda_viscosity * reg.surface_viscosity_loss(
                    grid, cells_n, eta=cfg.viscosity_eta, h=h)
            if cfg.use_sign_change:
                cells = sample("sign_change", cfg.norm_surface_sparsity)
                loss = loss + reg_scale * hp.lambda_sign_change * reg.surface_sign_change_loss(
                    grid, cells)
            loss = loss + _aux_reg_losses(grid, hp, cfg, generator, starts)
            if "fake_sample_std" in params:
                # L1/L2 on fake_sample_std (svox2.py:6073-6075)
                fss = grid.fake_sample_std
                loss = loss + (hp.lambda_fs_std_l2 * torch.sum(fss ** 2)
                               + hp.lambda_fs_std_l1 * torch.sum(torch.abs(fss)))
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        g = {k: torch.zeros_like(p) if gk is None else gk
             for (k, p), gk in zip(params.items(), grads)}

        # The JAX step keeps the old parameters when its pool overflowed
        # (steps.py:408-437). The port's pool is sized exactly and never
        # overflows (the compact and dense renderers have no pool budget:
        # JAX reports 0 for them), so this is a host-side check of a Python
        # 0 and the update always applies.
        overflow = out.get("pool_overflow", 0)
        if overflow == 0 or hp.force_apply > 0:
            beta = cfg.rms_beta
            rmsprop_step(grid.density_data, rms["density"], g["density"], hp.lr_alpha, beta)
            rmsprop_step(grid.sh_data, rms["sh"], g["sh"], hp.lr_sh, beta)
            clip = None if cfg.surf_grad_abs_max is None else abs(cfg.surf_grad_abs_max)
            rmsprop_step(grid.surface_data, rms["surface"], g["surface"], hp.lr_surface, beta,
                         grad_abs_max=clip, frozen=not hp.surface_unfrozen > 0)
            if "fake_sample_std" in params:
                rmsprop_step(grid.fake_sample_std, rms["fake_sample_std"],
                             g["fake_sample_std"], hp.lr_fake_sample_std, beta,
                             minval=1e-8)  # opt.py:1141-1142
            _step_basis(grid, rms, g, hp, beta)
            _step_background(grid, rms, g, hp, beta)
        stats = {"loss": loss.detach(), "mse": mse.detach(),
                 "pool_overflow": torch.zeros((), dtype=torch.int32, device=mse.device)}
        return grid, rms, stats

    return step


def make_cuvol_step(cfg: StepConfig):
    """The Plenoxels warm-start step, as the JAX package's (steps.py:447-536).

    ``step(grid, rms, rays, rgb_gt, hp, generator, occ=None, row_coords=None,
    window_starts=None) -> (grid, rms, stats)``, as ``make_surface_step``:
    the mse of the cuvol render, plus ``reg_scale * lambda_tv`` times the TV
    of density and ``reg_scale * lambda_tv_sh`` times the TV of SH over
    windows ``"tv"`` and ``"tv_sh"`` (``CUVOL_WINDOWS``), then masked
    RMSprop of density (``lr_sigma``) and SH (``lr_sh``) in place. As in
    JAX (steps.py:469-485), the render is the packed renderer (K8 over K2's
    pool) when ``cfg.renderer`` is "packed" and ``occ``, the words of
    ``render.cuvol.density_occupancy_words``, are given; otherwise the dense
    march (K10 and its backward) of at most ``cfg.max_steps`` steps."""
    _check_config(cfg)

    def step(grid: SparseGrid, rms: dict, rays: Rays, rgb_gt: torch.Tensor, hp: HParams,
             generator: torch.Generator, occ=None, row_coords=None, window_starts=None):
        _check_rms(rms)
        starts = _window_starts(window_starts, CUVOL_WINDOWS)
        reg_scale, sample = _sampler(generator, grid, row_coords, starts)
        params = {k: p for k, p in _trained(grid, rms).items()
                  if k not in ("surface", "fake_sample_std")}
        with _requires_grad(list(params.values())):
            if cfg.renderer == "packed" and occ is not None:
                out = volume_render_cuvol_packed(grid, rays, cfg.opt, occupancy=occ)
            else:
                out = volume_render_cuvol(grid, rays, cfg.opt, max_steps=cfg.max_steps)
            mse = torch.mean((out["rgb"] - rgb_gt) ** 2)
            loss = mse
            cells = sample("tv", cfg.tv_sparsity)
            loss = loss + reg_scale * hp.lambda_tv * reg.tv_loss(grid, grid.density_data, cells)
            cells = sample("tv_sh", cfg.tv_sh_sparsity)
            loss = loss + reg_scale * hp.lambda_tv_sh * reg.tv_loss(grid, grid.sh_data, cells)
            loss = loss + _aux_reg_losses(grid, hp, cfg, generator, starts)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        g = {k: torch.zeros_like(p) if gk is None else gk
             for (k, p), gk in zip(params.items(), grads)}

        # the JAX step keeps the old parameters when its pool overflowed
        # (steps.py:520-530); the port's pool never overflows (see
        # make_surface_step)
        overflow = out.get("pool_overflow", 0)
        if overflow == 0 or hp.force_apply > 0:
            rmsprop_step(grid.density_data, rms["density"], g["density"], hp.lr_sigma,
                         cfg.rms_beta)
            rmsprop_step(grid.sh_data, rms["sh"], g["sh"], hp.lr_sh, cfg.rms_beta)
            _step_basis(grid, rms, g, hp, cfg.rms_beta)
            _step_background(grid, rms, g, hp, cfg.rms_beta)
        stats = {"loss": loss.detach(), "mse": mse.detach(),
                 "pool_overflow": torch.zeros((), dtype=torch.int32, device=mse.device)}
        return grid, rms, stats

    return step
