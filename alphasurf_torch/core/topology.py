"""Sparse-topology mutation of the stage transitions: pruning, the density ->
SDF conversion and lattice resampling, the counterpart of the JAX package's
``core.topology`` with the semantics of its device path
``core.topology_device`` (svox2.py:2874-3225, 3963-4418).

The JAX package runs these on the host below 128^3 and on the device above;
its tests hold the two equal. The port has one path, the device one, with
two hand-written CUDA kernels on the card (``csrc/topology.cu``) and their
plain PyTorch versions here, which the wrappers take for tensors on the CPU:

  K9a ``keep_mask`` / ``prune_keep_mask`` / ``lv_band_mask``
        a keep mask on a dense lattice: a threshold (or the prune rule),
        dilated with a (2n+1)^3 Chebyshev window; and the level-set band
  K9b ``resample_channel`` / ``resample_rows``
        trilinear resample of packed rows onto a new lattice, with a fill
        for empty old vertices: one channel at every new vertex, or every
        channel at the kept ones

Around them, as the JAX package does outside any device routine of its
own, plain PyTorch: the links cumsum and the kept ids, the prune row
gather, the metric-rescale reduction and the top-k threshold. The camera
sweeps (K9c, K9d, K9e) are in ``core.weight_render``.

Interpolation weights come from per-axis tables computed on the host in
float64 and rounded to float32, as ``_interp_matrix`` does (positions
recomputed in float32 would differ in the last bit and flip thresholds).
The resample is the JAX package's separable one, along x, then y, then z;
each of its 1-D matrices has two non-zero entries a row, so the values are
the lerps of the 8 corners in that order.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import defs, kernels
from .grid import CORNER_OFFSETS, SparseGrid


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------

def _interp_table(curr: int, new: int, centered: bool):
    """(l int64, f float32) of ``topology_device._interp_matrix``: new
    vertex i lies in old cell l[i] at weight f[i] on corner l + 1 (and
    float32(1 - f[i]) on corner l); positions in float64, clipped to
    [0, curr-1], the cell to <= curr-2, f rounded to float32 last."""
    if centered:
        fact = 0.5 * curr / new
        x = np.linspace(fact - 0.5, curr - fact - 0.5, new, dtype=np.float64)
    else:
        x = np.linspace(0.0, curr - 0.5, new, dtype=np.float64)
    x = np.clip(x, 0.0, curr - 1.0)
    l = np.minimum(x.astype(np.int64), curr - 2)
    return l, (x - l).astype(np.float32)


def resample_tables(curr_reso, new_reso, centered: bool, device) -> tuple:
    """Per axis (l int32, f, g float32) on ``device``: the cell and the two
    corner weights of each new vertex, g = float32(1 - f) as in the JAX
    package's float32 matrices."""
    out = []
    for c, n in zip(curr_reso, new_reso):
        l, f = _interp_table(int(c), int(n), centered)
        g = (np.float32(1.0) - f).astype(np.float32)
        out.append(tuple(torch.as_tensor(a, device=device) for a in (l.astype(np.int32), f, g)))
    return tuple(out)


# ---------------------------------------------------------------------------
# K9b: resample
# ---------------------------------------------------------------------------

def _dense_of(links: torch.Tensor, col: torch.Tensor, fill: float) -> torch.Tensor:
    """(X, Y, Z) field of the packed column ``col``, ``fill`` where empty."""
    flat = links.reshape(-1)
    present = flat >= 0
    out = torch.full((flat.numel(),), float(fill), dtype=col.dtype, device=col.device)
    out[present] = col[flat[present].long()]
    return out.reshape(links.shape)


def _resample_dense_plain(dense: torch.Tensor, tables) -> torch.Tensor:
    """Plain version of K9b on a dense field: the lerp along x of every
    (y, z) column, then along y, then along z, each g*a + f*b; weights in
    the field's dtype."""
    v = dense
    for ax, (l, f, g) in enumerate(tables):
        l = l.long()
        shape = [1, 1, 1]
        shape[ax] = -1
        f = f.to(v.dtype).reshape(shape)
        g = g.to(v.dtype).reshape(shape)
        v = g * v.index_select(ax, l) + f * v.index_select(ax, l + 1)
    return v


def resample_channel(links, col, fill: float, tables, new_reso) -> torch.Tensor:
    """K9b at every new vertex: the (Xn, Yn, Zn) resample of the packed
    column ``col`` (cap,). The kernel on the card, the plain version on the
    CPU (in ``col``'s dtype)."""
    if not links.is_cuda:
        return _resample_dense_plain(_dense_of(links, col, fill), tables)
    return kernels.resample_dense(links, col.contiguous(), fill, tables, new_reso)


def _touched_plain(links, kept, tables, new_reso) -> torch.Tensor:
    """Whether a corner of each kept vertex's old cell is empty (the
    ``non_expanding`` test of ``_cell_matrix``)."""
    Yn, Zn = int(new_reso[1]), int(new_reso[2])
    ijk = (kept // (Yn * Zn), (kept // Zn) % Yn, kept % Zn)
    base = [tables[a][0].long()[ijk[a]] for a in range(3)]
    X, Y, Z = links.shape
    out = torch.zeros(kept.shape[0], dtype=torch.bool, device=kept.device)
    for dx, dy, dz in CORNER_OFFSETS.tolist():
        lk = links[base[0] + dx, base[1] + dy, base[2] + dz]
        out |= lk < 0
    return out


def _resample_rows_plain(links, rows, fills, kept, tables, new_reso, want_touched: bool):
    """Plain version of K9b at the kept vertices: channel by channel, the
    dense resample gathered at ``kept`` (as ``_gather_channels_j``)."""
    out = torch.empty((kept.shape[0], rows.shape[1]), dtype=rows.dtype, device=rows.device)
    for c in range(rows.shape[1]):
        v = _resample_dense_plain(_dense_of(links, rows[:, c], float(fills[c])), tables)
        out[:, c] = v.reshape(-1)[kept]
    touched = _touched_plain(links, kept, tables, new_reso) if want_touched else None
    return out, touched


def resample_rows(links, rows, fills, kept, tables, new_reso, want_touched: bool = False):
    """K9b at the kept vertices: (N, C) rows resampled from ``rows`` (cap,
    C), channel c filled with ``fills[c]`` at empty corners, and (with
    ``want_touched``) whether a corner of each old cell was empty."""
    if not links.is_cuda:
        return _resample_rows_plain(links, rows, fills, kept, tables, new_reso, want_touched)
    f = torch.as_tensor(np.asarray(fills, np.float32), device=links.device)
    return kernels.resample_rows(links, rows.contiguous(), f, kept, tables, new_reso, want_touched)


# ---------------------------------------------------------------------------
# K9a: keep masks
# ---------------------------------------------------------------------------

def _window_or_plain(m: torch.Tensor, axis: int, a: int, b: int, n_out: int) -> torch.Tensor:
    """out[i] = OR of m[i + a .. i + b] along ``axis``, within m."""
    n_in = m.shape[axis]
    front, back = max(0, -a), max(0, n_out - 1 + b - (n_in - 1))
    pad = [0] * 6
    pad[2 * (2 - axis)], pad[2 * (2 - axis) + 1] = front, back
    p = torch.nn.functional.pad(m.to(torch.uint8), pad)
    out = None
    for s in range(a, b + 1):
        part = p.narrow(axis, s + front, n_out)
        out = part.clone() if out is None else out | part
    return out.bool()


def _dilate_plain(m: torch.Tensor, n: int) -> torch.Tensor:
    """The (2n+1)^3 box maximum of a bool mask (zero outside), as
    ``reduce_window`` "SAME" in ``_mask_pass_j``."""
    if n <= 0:
        return m
    for ax in range(3):
        m = _window_or_plain(m, ax, -n, n, m.shape[ax])
    return m


def keep_mask(crit: torch.Tensor, thresh: float, dilate: int) -> torch.Tensor:
    """K9a: ``crit >= thresh`` dilated by a (2 dilate + 1)^3 window, as
    ``_mask_pass_j``."""
    if not crit.is_cuda:
        return _dilate_plain(crit >= thresh, int(dilate))
    return kernels.keep_mask(crit.contiguous(), thresh, dilate)


def _prune_valid_plain(links, dens_col, surf_col, thresh: float) -> torch.Tensor:
    dens = _dense_of(links, dens_col, 0.0)
    valid = dens > thresh
    if surf_col is not None:
        s = _dense_of(links, surf_col, 0.0)
        sp = torch.nn.functional.pad(s, (1, 1, 1, 1, 1, 1))
        X, Y, Z = s.shape
        sign_change = torch.zeros_like(valid)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    nb = sp[1 + dx:1 + dx + X, 1 + dy:1 + dy + Y, 1 + dz:1 + dz + Z]
                    sign_change |= (s == 0) | (nb == 0) | (torch.sign(s) != torch.sign(nb))
        valid &= sign_change
    return valid


def prune_keep_mask(links, dens_col, surf_col, thresh: float, dilate: int) -> torch.Tensor:
    """K9a, the prune rule of ``_prune_mask_j``: present density > thresh
    (and, with ``surf_col``, a surface sign change or zero among the 27
    neighbours), dilated."""
    if not links.is_cuda:
        return _dilate_plain(_prune_valid_plain(links, dens_col, surf_col, thresh), int(dilate))
    return kernels.prune_mask(links, dens_col.contiguous(),
                              None if surf_col is None else surf_col.contiguous(), thresh, dilate)


def _lv_band_plain(surf: torch.Tensor, level_sets) -> torch.Tensor:
    X, Y, Z = surf.shape
    smin = smax = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                s = surf[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
                smin = s if smin is None else torch.minimum(smin, s)
                smax = s if smax is None else torch.maximum(smax, s)
    straddle = torch.zeros(smin.shape, dtype=torch.bool, device=surf.device)
    for lv in level_sets:
        straddle |= (lv >= smin) & (lv <= smax)
    m = _window_or_plain(straddle, 0, -1, 0, X)
    m = _window_or_plain(m, 1, -1, 0, Y)
    return _window_or_plain(m, 2, -1, 0, Z)


def lv_band_mask(surf: torch.Tensor, level_sets: torch.Tensor) -> torch.Tensor:
    """K9a, the level-set band of ``_lv_band_mask_j``: the 8 corners of
    every voxel of the dense surface whose corner range holds a level set."""
    if not surf.is_cuda:
        return _lv_band_plain(surf, level_sets)
    return kernels.lv_band(surf.contiguous(), level_sets.float().contiguous())


# ---------------------------------------------------------------------------
# plain PyTorch around the kernels
# ---------------------------------------------------------------------------

def _links_pass(mask: torch.Tensor):
    """New links (int32, -1 where dropped) and the kept flat ids (int64)
    of a keep mask (``_links_pass_j``)."""
    flat = mask.reshape(-1)
    links = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32) - 1
    links = torch.where(flat, links, torch.full_like(links, -1)).reshape(mask.shape)
    return links, torch.nonzero(flat)[:, 0]


def _histogram(x: torch.Tensor, bins: int, lo: float, hi: float) -> np.ndarray:
    """``jnp.histogram(x, bins, range=(lo, hi))[0]``: edges as jnp.linspace
    makes them in x's dtype (lo (1 - s) + hi s, s = i / bins), right-closed
    last bin, values outside dropped."""
    dt = x.dtype
    lo_t = torch.tensor(lo, dtype=dt, device=x.device)
    hi_t = torch.tensor(hi, dtype=dt, device=x.device)
    if lo_t == hi_t:
        lo_t, hi_t = lo_t - 0.5, hi_t + 0.5
    s = torch.arange(bins, dtype=dt, device=x.device) / torch.tensor(float(bins), dtype=dt,
                                                                      device=x.device)
    edges = torch.cat([lo_t * (1 - s) + hi_t * s, hi_t[None]])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.bincount(idx, minlength=bins + 2)
    return counts[1:bins + 1].cpu().numpy()


def _kth_largest_thresh(crit_flat: torch.Tensor, k: int, thresh: float) -> float:
    """Raise ``thresh`` so that at most k elements of crit are >= it
    (``topology_device._kth_largest_thresh``, svox2.py:4091-4105): exact by
    sort up to 2^22 elements, else the upper edge of the sub-bin of a
    two-pass 4096-bin histogram that holds the k-th largest."""
    size = crit_flat.numel()
    if k <= 0 or k >= size:
        return thresh
    n_over = int((crit_flat >= thresh).sum())
    if n_over <= k:
        return thresh
    if size <= (1 << 22):
        s = torch.sort(crit_flat).values
        return max(thresh, float(s[size - k]))
    lo, hi = float(crit_flat.min()), float(crit_flat.max())
    for _ in range(2):
        if hi <= lo:
            return max(thresh, lo)
        h = _histogram(crit_flat, 4096, lo, hi)
        cum_from_top = np.cumsum(h[::-1])[::-1]
        n_above_range = int((crit_flat > hi).sum())
        tot = cum_from_top + n_above_range
        binw = (hi - lo) / 4096
        idx = int(np.searchsorted(-tot, -k))
        if idx == 0:
            return max(thresh, lo)
        lo, hi = lo + (idx - 1) * binw, lo + idx * binw
    return max(thresh, hi)


def grid_h(grid: SparseGrid) -> float:
    """Mean world size of one voxel (svox2.py:3228-3232)."""
    gsz = float(np.mean(grid.reso))
    return 2.0 * float(grid.radius.detach().double().mean()) / gsz


def prune_grid(grid: SparseGrid, density_raw_thres: float = 1.0, dilate: int = 2,
               prune_surf: bool = True) -> SparseGrid:
    """Keep the vertices of raw density > ``density_raw_thres`` (and, with
    ``prune_surf``, a surface sign change among the 27 neighbours),
    dilated; kept vertices keep their old rows, zero where the old link was
    empty (svox2.py:2874-2951; ``prune_grid_device``)."""
    do_surf = prune_surf and grid.surface_data is not None
    mask = prune_keep_mask(grid.links, grid.density_data.detach()[:, 0],
                           grid.surface_data.detach()[:, 0] if do_surf else None,
                           float(density_raw_thres), int(dilate))
    links_new, kept = _links_pass(mask)
    parts = [grid.density_data, grid.sh_data]
    if grid.surface_data is not None:
        parts.append(grid.surface_data)
    rows = torch.cat([p.detach() for p in parts], dim=1)
    old = grid.links.reshape(-1)[kept].long()
    vals = rows[torch.clamp(old, 0, rows.shape[0] - 1)] * (old >= 0)[:, None].to(rows.dtype)
    C_sh = grid.sh_data.shape[1]
    out = dict(links=links_new, density_data=vals[:, :1], sh_data=vals[:, 1:1 + C_sh])
    if grid.surface_data is not None:
        out["surface_data"] = vals[:, 1 + C_sh:]
    return grid.replace(**out)


def _metric_rescale(grid: SparseGrid) -> SparseGrid:
    """Divide surface and level sets by the mean finite-difference gradient
    norm over the cells whose 000/100/010/001 corners are present
    (svox2.py:3069-3113), as ``metric_rescale_device``: the voxel size
    rounded to float32, level sets divided in their own dtype."""
    h = float(np.float32(grid_h(grid)))
    links = grid.links
    p = links >= 0
    s = _dense_of(links, grid.surface_data.detach()[:, 0], 0.0)
    ok = p[:-1, :-1, :-1] & p[1:, :-1, :-1] & p[:-1, 1:, :-1] & p[:-1, :-1, 1:]
    s000 = s[:-1, :-1, :-1]
    g = torch.sqrt(((s[1:, :-1, :-1] - s000) / h) ** 2 + ((s[:-1, 1:, :-1] - s000) / h) ** 2
                   + ((s[:-1, :-1, 1:] - s000) / h) ** 2)
    cnt = int(ok.sum())
    if cnt == 0:
        return grid
    mg = float(torch.sum(g * ok.to(g.dtype)) / cnt)
    if mg <= 0:
        return grid
    return grid.replace(surface_data=grid.surface_data.detach() / mg,
                 level_set_data=grid.level_set_data / mg)


def init_surface_from_density(
    grid: SparseGrid,
    density_lvs: List[float] = (0.5,),
    alpha_rescale: Optional[float] = None,
    prune_threshold: float = 1e-8,
    dilate: int = 2,
    zero_lv_density: Optional[float] = None,
    init_type: str = "density",
    weight_init_cams=None,
    visibility_pruning_scale: float = 0.0,
    mask_pruning_rays=None,
    rng=None,
) -> SparseGrid:
    """Plenoxels density -> SDF (svox2.py:2954-3225): surface = density -
    zero_lv, level sets = density_lvs - zero_lv (both in float32, as the
    JAX package computes them; the level sets stay float32), then
    ``prune_grid`` without the surface rule, the metric rescale, the
    ``alpha_rescale`` of density and, with cameras, visibility pruning: the
    surface of each vertex seen fewer than ``visibility_pruning_scale``
    times the most-seen one's count becomes (vis - thresh) / thresh *
    min(surface), computed in float32. ``init_type="weight"`` scales the
    density by each vertex's largest camera transmittance (K9e) before the
    shift, in float32. ``mask_pruning_rays`` (a ray batch with ``mask``
    or ``masks``, on the host or the grid's device) first zeroes the
    density of every vertex that no masked ray reaches (K9f over the masked
    rays) and of every vertex that an unmasked ray reaches (K9f over the
    others), svox2.py:2981-3014."""
    if mask_pruning_rays is not None:
        from .weight_render import sparse_grid_mask_render

        m = getattr(mask_pruning_rays, "masks", None)
        m = torch.as_tensor(mask_pruning_rays.mask if m is None else m).to(torch.bool)
        o = torch.as_tensor(mask_pruning_rays.origins)
        d = torch.as_tensor(mask_pruning_rays.dirs)
        m = m.to(o.device)
        dens = grid.density_data.detach()
        if bool(m.any()):
            obj = sparse_grid_mask_render(grid, o[m], d[m])
            dens = dens * obj[:, None]
            grid = grid.replace(density_data=dens)
        if bool((~m).any()):
            empty = sparse_grid_mask_render(grid, o[~m], d[~m])
            grid = grid.replace(density_data=dens * (1.0 - empty)[:, None])
    density_lvs = list(density_lvs)
    if zero_lv_density is None:
        zero_lv_density = density_lvs[len(density_lvs) // 2]
    dt, dev = grid.dtype, grid.links.device
    level_sets = torch.as_tensor(np.asarray(density_lvs, np.float32) - zero_lv_density,
                                 device=dev)
    surface = grid.density_data.detach().float() - zero_lv_density
    if init_type == "weight":
        # svox2.py:3122-3148: density times the vertex's max transmittance
        if not weight_init_cams:
            raise ValueError("init_type='weight' requires cameras")
        from .weight_render import sparse_grid_weight_render

        wt = sparse_grid_weight_render(grid, weight_init_cams)
        surface = grid.density_data.detach().float() * wt[:, None] - zero_lv_density
    grid = grid.replace(surface_data=surface.to(dt), level_set_data=level_sets,
                 surface_type=defs.SURFACE_TYPE_SDF
                 if grid.surface_type == defs.SURFACE_TYPE_NONE else grid.surface_type)
    grid = prune_grid(grid, prune_threshold, dilate, prune_surf=False)
    grid = _metric_rescale(grid)
    if alpha_rescale is not None:
        grid = grid.replace(density_data=grid.density_data.detach() * alpha_rescale)

    if visibility_pruning_scale > 0 and weight_init_cams:
        from .weight_render import sparse_grid_visibility_render_surf

        vis = sparse_grid_visibility_render_surf(grid, weight_init_cams)
        thresh = visibility_pruning_scale * float(vis.max())
        if thresh > 0:
            surf = grid.surface_data.detach().clone()
            surf_min = float(surf.min())
            low = vis < thresh
            surf[low, 0] = ((vis[low] - thresh) / thresh * surf_min).to(dt)
            grid = grid.replace(surface_data=surf)
    return grid


def _resample_common(grid: SparseGrid, new_reso, centered: bool, fill_density: float, cameras,
                     weight_thresh: float, value_thresh: float, max_elements: int,
                     weight_render_stop_thresh: float, last_sample_opaque: bool, dilate: int):
    """The shared start of both resamples: the new lattice's tables, its
    resampled density, the keep mask and its threshold."""
    from .weight_render import grid_weight_render

    tables = resample_tables(grid.reso, new_reso, centered, grid.links.device)
    dens_new = resample_channel(grid.links, grid.density_data.detach()[:, 0], fill_density,
                                tables, new_reso)
    if cameras is not None:
        crit = grid_weight_render(dens_new, cameras, grid.offset, grid.scaling,
                                  stop_thresh=weight_render_stop_thresh)
        thresh = _kth_largest_thresh(crit.reshape(-1), max_elements, weight_thresh)
    else:
        crit = dens_new
        thresh = _kth_largest_thresh(crit.reshape(-1), max_elements, value_thresh)
    if last_sample_opaque:
        crit = crit.clone()
        crit[:, :, -1] = float("inf")
    return tables, keep_mask(crit, thresh, dilate)


def _norm_reso(new_reso) -> tuple:
    if isinstance(new_reso, int):
        new_reso = (new_reso,) * 3
    return tuple(int(r) for r in new_reso)


def resample(grid: SparseGrid, new_reso, sigma_thresh: float = 5.0, weight_thresh: float = 0.01,
             dilate: int = 2, cameras=None, weight_render_stop_thresh: float = 0.2,
             max_elements: int = 0, last_sample_opaque: bool = False) -> SparseGrid:
    """Resample and sparsify a density (cuvol) grid onto a new voxel-centre
    lattice (svox2.py:3963-4167; ``resample_device``): keep by density >=
    ``sigma_thresh`` or, with cameras, by the largest ray weight >=
    ``weight_thresh`` (K9c), bounded to ``max_elements``, dilated."""
    new_reso = _norm_reso(new_reso)
    tables, mask = _resample_common(grid, new_reso, True, 0.0, cameras, weight_thresh,
                                    sigma_thresh, max_elements, weight_render_stop_thresh,
                                    last_sample_opaque, dilate)
    links_new, kept = _links_pass(mask)
    rows = torch.cat([grid.density_data.detach(), grid.sh_data.detach()], dim=1)
    vals, _ = resample_rows(grid.links, rows, [0.0] * rows.shape[1], kept, tables, new_reso)
    return grid.replace(links=links_new, density_data=vals[:, :1], sh_data=vals[:, 1:])


def resample_surface(grid: SparseGrid, new_reso, alpha_thresh: float = 1e-6,
                     weight_thresh: float = 0.01, dilate: int = 2, cameras=None,
                     weight_render_stop_thresh: float = 0.2, max_elements: int = 0,
                     alpha_empty_val: float = -20.0, non_expanding: bool = False,
                     sigmoid_alpha: bool = False, keep_lv_band: bool = False) -> SparseGrid:
    """Resample and sparsify a surface grid onto a new vertex lattice
    (svox2.py:4172-4418; ``resample_surface_device``): keep by raw alpha
    (a sigmoid threshold through its logit) or by the largest ray weight
    (K9c), bounded to ``max_elements``, dilated; ``keep_lv_band`` also keeps
    the corners of voxels whose resampled surface straddles a level set;
    ``non_expanding`` drops new vertices whose old cell had an empty corner.
    Empty old vertices read as ``alpha_empty_val`` (under sigmoid_alpha,
    else 0) for density, 0 for SH and -1 for the surface."""
    new_reso = _norm_reso(new_reso)
    empty_alpha = float(alpha_empty_val) if sigmoid_alpha else 0.0
    at = float(alpha_thresh)
    if sigmoid_alpha:
        at = float(np.log(at / (1.0 - at)))
    tables, mask = _resample_common(grid, new_reso, False, empty_alpha, cameras, weight_thresh,
                                    at, max_elements, weight_render_stop_thresh, False, dilate)
    if keep_lv_band and grid.level_set_data is not None:
        surf_new = resample_channel(grid.links, grid.surface_data.detach()[:, 0], -1.0, tables,
                                    new_reso)
        mask = mask | lv_band_mask(surf_new, grid.level_set_data)
        del surf_new
    links_new, kept = _links_pass(mask)
    C_sh = grid.sh_data.shape[1]
    rows = torch.cat([grid.density_data.detach(), grid.sh_data.detach(),
                      grid.surface_data.detach()], dim=1)
    fills = [empty_alpha] + [0.0] * C_sh + [-1.0]
    vals, touched = resample_rows(grid.links, rows, fills, kept, tables, new_reso,
                                  want_touched=non_expanding)
    if non_expanding:
        keep = ~touched
        flat = mask.reshape(-1).clone()
        flat[kept] = keep
        links_new, _ = _links_pass(flat.reshape(mask.shape))
        vals = vals[keep]
    return grid.replace(links=links_new, density_data=vals[:, :1], sh_data=vals[:, 1:1 + C_sh],
                 surface_data=vals[:, 1 + C_sh:2 + C_sh])


def upsample(grid: SparseGrid, new_reso, alpha_upsample_thresh: float = -1e9, dilate: int = 2,
             cameras=None, weight_thresh: float = 0.01, max_elements: int = 0,
             non_expanding: bool = False, sigmoid_alpha: bool = False,
             keep_lv_band: bool = False) -> SparseGrid:
    """The Trainer's upsample (opt.py:1256-1272): ``resample_surface`` for
    surface grids, ``resample`` for density grids."""
    if grid.surface_data is not None:
        return resample_surface(
            grid, new_reso, alpha_thresh=alpha_upsample_thresh, weight_thresh=weight_thresh,
            dilate=dilate, cameras=cameras, max_elements=max_elements,
            non_expanding=non_expanding, sigmoid_alpha=sigmoid_alpha, keep_lv_band=keep_lv_band)
    return resample(grid, new_reso, sigma_thresh=alpha_upsample_thresh,
                    weight_thresh=weight_thresh, dilate=dilate, cameras=cameras,
                    max_elements=max_elements)


def sparsify_background(grid: SparseGrid, sigma_thresh: float = 1.0,
                        dilate: int = 1) -> SparseGrid:
    """Drop the MSI background's links whose density is below
    ``sigma_thresh`` in every layer after a ``dilate``-fold 6-neighbour
    dilation over (v, u, layer) (svox2.py:4422-4444): the JAX package's
    host numpy (topology.py:513-546), links renumbered in flat order."""
    if grid.background_data is None:
        return grid
    links = grid.background_links.cpu().numpy().copy()
    data = grid.background_data.detach()
    H, W = links.shape
    n_layers = data.shape[1]
    flat = links.reshape(-1)
    nonempty = flat >= 0
    sigma_mask = np.zeros((H * W, n_layers), bool)
    sigma_mask[nonempty] = (data[torch.as_tensor(flat[nonempty], device=data.device).long(), :, -1]
                            >= sigma_thresh).cpu().numpy()
    sigma_mask = sigma_mask.reshape(H, W, n_layers)
    for _ in range(int(dilate)):
        m = sigma_mask
        grown = m.copy()
        grown[1:] |= m[:-1]
        grown[:-1] |= m[1:]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        grown[..., 1:] |= m[..., :-1]
        grown[..., :-1] |= m[..., 1:]
        sigma_mask = grown
    keep = sigma_mask.any(-1) & nonempty.reshape(H, W)
    old_rows = torch.as_tensor(links[keep], device=data.device).long()
    new_links = np.full((H, W), -1, np.int32)
    new_links[keep] = np.arange(keep.sum(), dtype=np.int32)
    return grid.replace(background_links=torch.as_tensor(new_links, device=data.device),
                        background_data=data[old_rows])
