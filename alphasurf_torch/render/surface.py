"""Surface renderers, the counterparts of the JAX package's
``render.surface`` (svox2's ``trace_ray_surf_trav`` forward): the packed
renderer, the dense DDA walk and the K-slot compact renderer.

One chunk of rays renders in four steps, each a hand-written CUDA kernel on
the card (``alphasurf_torch/csrc``) and a plain PyTorch version here, which
the wrappers take for tensors that lie on the CPU:

  K1 ``occupancy_words``        which voxels can contribute, bit-packed on z
  K2 ``compact_crossings_packed`` every occupied (ray, voxel) crossing,
                                 ray-major and t-ascending, sized exactly
                                 (per-ray count, exclusive scan, per-ray fill);
                                 K11a ``dense_walk`` lists the occupied voxels
                                 of the dense walk instead, K11b
                                 ``compact_crossings`` the first K crossings
  K3 ``voxel_samples``          per pool entry: cubic roots, fake sample,
                                 alpha, SH colour, normal, inward/lap terms
  K4 ``composite``              per ray: transmittance, weights, colour,
                                 depths, the streaming ray losses and (K11c)
                                 the first-K sample cache

The three renderers differ only in the pool and in three compositor rules
(``_Mode``), so all share K3, K4 and the backward.

Gradients: when a parameter of the grid requires grad, the plain path on the
CPU is differentiated by autograd, detached where the JAX package stops
gradients; on the card ``_SurfaceFn`` runs K3 and K4 forward and K5
(``csrc/backward.cu``) backward, for the cotangents of every output the JAX
package differentiates: ``rgb`` and ``ray_losses`` (K5's rgb-only
instantiations), and depth, normal, log_T (alpha, log_transmit), the mode,
median and sigma-thresh depths, the cache's ts, alphas, weights (K11d) and
median, the intersections' points, alphas and weights and the samples'
(K5's second instantiations). Clamps in the plain path are a maximum then a
minimum, as ``jnp.clip``, so an exact tie passes half the gradient there
too.

A grid with an MSI background composites it behind the foreground in every
renderer: K13 (``render.background``) gives each ray its background colour,
which K4 takes where it took the brightness, and K5 backward carries the
colour's cotangent to K13's backward kernel.

The per-ray basis ``sh_mult`` (SH, or a learned 3D texture or MLP,
``core.sh.eval_basis``) is an input of ``_SurfaceFn``: under a gradient K5b
also returns its cotangent (B, bd), which autograd carries on into the
learned basis's parameters.

Two output options of K3/K4 serve the extractors: ``depth_sigma_thresh``
(K4's walk keeps a per-ray minimum) and ``return_intersections`` (K4 writes
each slot's weight and contribution flag; ``intersect_points`` the world
points); the walks' ``return_samples`` takes K11a's walk steps and K4's
truncated alphas of the live slots. Every surface type is carried: SDF and
the UDF types (softplus corners; UDF_ALPHA's per-level-set alphas; the
udf-var loss) through the cubic roots, PLANE through the corners' mean
plane, VOXEL_FACE through one sample at each voxel's entry, in the plain
versions and in K1, K3, K4 and K5 alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import defs, kernels
from ..core.grid import CORNER_OFFSETS, UDF_TYPES, SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Rays
from ..core.sh import eval_basis
from ..ops import dda
from ..ops.cubic import cubic_coeffs_T, cubic_roots_T
from ..ops.trilerp import trilerp_weights_T
from .background import background_color

_SNAP_TOL = 1e-5  # grid units; > f32 roundoff of o + t*d at t ~ grid diag
_RAY_LOSS_KEYS = (
    "l_dist", "l_dist_a", "l_entropy", "l_entropy_a",
    "sp_logsig", "sp_logsig_w", "sp_w",
    "l_inward", "lap_sum", "lap_cnt", "udf_var_sum", "udf_var_cnt",
)
# the per-entry sums K3 writes (``loss_e``, 3 rows, 5 for the UDF types),
# which K4 sums per ray into ray losses 7-11
_LOSS_E_KEYS = _RAY_LOSS_KEYS[7:]


def surf_alpha_act(raw: torch.Tensor, activation_type: int) -> torch.Tensor:
    """Alpha activation (render_util.cuh:2138-2156; svox2.py:2322-2326)."""
    if activation_type == defs.SIGMOID_FN:
        return torch.sigmoid(raw)
    return 1.0 - torch.exp(-torch.relu(raw))


def trunc_vol_render_rw(intersect_ids: torch.Tensor, a, weight_min: float) -> torch.Tensor:
    """Truncated-vol-render cosine ramp (svox2.py:4740-4746)."""
    x = torch.clamp(a - intersect_ids.to(a.dtype), 0.0, 1.0)
    return torch.clamp(0.5 * (1.0 - torch.cos(math.pi * x)), min=weight_min)


def trilerp_field_grad_T(vals8T: torch.Tensor, posT: torch.Tensor) -> torch.Tensor:
    """Gradient of the trilinear field w.r.t. position, corner/component
    axes leading: vals8T (8, ...), posT (3, ...) -> (3, ...)
    (compute_field_grad, render_util.cuh:2191)."""
    s000, s001, s010, s011, s100, s101, s110, s111 = (vals8T[i] for i in range(8))
    x, y, z = posT[0], posT[1], posT[2]
    c00 = s000 * (1 - z) + s001 * z
    c01 = s010 * (1 - z) + s011 * z
    c10 = s100 * (1 - z) + s101 * z
    c11 = s110 * (1 - z) + s111 * z
    c0 = c00 * (1 - y) + c01 * y
    c1 = c10 * (1 - y) + c11 * y
    gx = c1 - c0
    gy = x * (c11 - c10) + (1 - x) * (c01 - c00)
    gz = x * (y * (s111 - s110) + (1 - y) * (s101 - s100)) + (1 - x) * (
        y * (s011 - s010) + (1 - y) * (s001 - s000)
    )
    return torch.stack([gx, gy, gz], dim=0)


def _clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip``: a maximum, then a minimum. Same values as
    ``torch.clamp``, but an exact tie passes half the gradient, as in JAX."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in index order (the order the kernels add in)."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def pack_grid_data(grid: SparseGrid) -> torch.Tensor:
    """(density | surface | sh | pad) rows, one gatherable (cap, C8) array,
    C8 the channel count padded to a multiple of 8. Differentiable in the
    three parameters where they require grad. The surface block is 4
    channels for PLANE, 1 otherwise; UDF_ALPHA's density block is zeros
    (its alphas live per level set in the (n_lv, 1) ``density_data``,
    surface.py:133-154)."""
    dens = grid.density_data
    if grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
        dens = grid.sh_data.new_zeros((grid.capacity, 1))
    parts = [dens, grid.surface_data, grid.sh_data]
    c = 1 + grid.surface_data.shape[1] + grid.sh_data.shape[1]
    pad = (-c) % 8
    if pad:
        parts.append(grid.sh_data.new_zeros((grid.capacity, pad)))
    return torch.cat(parts, dim=1).contiguous()


def _check_supported(grid: SparseGrid, opt: RenderOptions) -> None:
    if grid.surface_data is None:
        raise NotImplementedError(
            "the surface renderer needs a surface grid; grids without one (cuvol) render "
            "through render.cuvol"
        )


def _prep_rays(grid: SparseGrid, rays: Rays, opt: RenderOptions):
    """Grid-space rays and their bounds: (origins, dirs, viewdirs, tnear,
    tmax, near_grid_t, ray_ok, delta_scale)."""
    origins, dirs, viewdirs, delta_scale = dda.preprocess_rays(grid, rays.origins, rays.dirs)
    tnear, tmax = dda.ray_bounds(grid, origins, dirs)
    if opt.use_spheric_clip:
        # the sphere is inscribed in the lattice box, so intersecting the two
        # bounds equals the reference's sphere-only clip (render_util.cuh:661)
        sp_near, sp_max = dda.spheric_bounds(grid, origins, dirs, opt.near_clip)
        tnear = torch.maximum(tnear, sp_near)
        tmax = torch.minimum(tmax, sp_max)
    if opt.use_spheric_clip or opt.near_clip == 0.0:
        near_grid_t = 0.0
    else:
        near_grid_t = float(opt.near_clip * torch.mean(grid.scaling * grid.gsz))
    ray_ok = torch.isfinite(tnear) & torch.isfinite(tmax) & (tnear <= tmax)
    return origins, dirs, viewdirs, tnear, tmax, near_grid_t, ray_ok, delta_scale


def _prep(grid: SparseGrid, rays: Rays, opt: RenderOptions):
    """``_prep_rays`` with the rays' basis ``sh_mult`` in the place of
    their view directions, as the JAX package's ``_prep``."""
    origins, dirs, viewdirs, *rest = _prep_rays(grid, rays, opt)
    return (origins, dirs, eval_basis(grid, viewdirs), *rest)


# ---------------------------------------------------------------------------
# K1: occupancy
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, logaddexp(x, 0): exact for large x, where
    ``F.softplus``'s threshold turns linear."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _hull_test(grid: SparseGrid, opt: RenderOptions) -> bool:
    """Whether the level-set hull filter applies: scalar surface fields
    (PLANE voxels always carry a plane, VOXEL_FACE samples every crossing),
    unless unrestricted fake samples are on (surface.py:1217-1225)."""
    scalar = grid.surface_type not in (defs.SURFACE_TYPE_PLANE, defs.SURFACE_TYPE_VOXEL_FACE)
    return scalar and not (opt.surf_fake_sample and not opt.limited_fake_sample)


def pack_occupancy_bits(occ: torch.Tensor) -> torch.Tensor:
    """Bit-pack a bool occupancy volume along z: (X, Y, Z) bool ->
    (X, Y, ceil(Z/32)) int32 words holding the bit pattern of
    the JAX package's uint32 words (bit k of word w is voxel z = 32w+k)."""
    X, Y, Z = occ.shape
    W = (Z + 31) // 32
    o = F.pad(occ.to(torch.int64), (0, W * 32 - Z)).reshape(X, Y, W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = torch.sum(o << shifts, dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_occupancy_bits(words: torch.Tensor, Z: int) -> torch.Tensor:
    """Inverse of ``pack_occupancy_bits``: (X, Y, W) int32 -> (X, Y, Z) bool."""
    X, Y, W = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(X, Y, W * 32)[..., :Z].bool()


def _occupancy_words_plain(grid: SparseGrid, opt: RenderOptions,
                           candidates: bool = False) -> torch.Tensor:
    """Plain version of K1, as the JAX package's ``voxel_occupancy``
    (surface.py:1149-1234): all 8 corner links present, max corner raw alpha
    >= sigma_thresh (UDF_ALPHA: the largest alpha of its level-set table)
    and, where ``_hull_test`` holds, a level set within the corners' surface
    hull (of the softplus of the UDF types' values). With ``candidates``,
    the voxels ``_candidate_test`` names instead."""
    sigma_thresh, hull = _candidate_test(grid, opt, candidates)
    links = grid.links
    present = links >= 0
    safe = torch.clamp(links, 0, grid.capacity - 1).long()
    surf_rows = grid.surface_data[:, 0].detach()
    if grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
        dens_rows = torch.amax(grid.density_data.detach()).expand(grid.capacity)
    else:
        dens_rows = grid.density_data[:, 0].detach()
    dens = torch.where(present, dens_rows[safe], torch.full_like(dens_rows[:1], -math.inf))
    surf = torch.where(present, surf_rows[safe], torch.zeros_like(surf_rows[:1]))
    if grid.surface_type in UDF_TYPES:
        surf = softplus(surf)

    def corners(v, reduce_fn):
        out = None
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    s = v[dx : v.shape[0] - 1 + dx,
                          dy : v.shape[1] - 1 + dy,
                          dz : v.shape[2] - 1 + dz]
                    out = s if out is None else reduce_fn(out, s)
        return out

    occ = corners(present, torch.logical_and) & (corners(dens, torch.maximum) >= sigma_thresh)
    if hull:
        smin = corners(surf, torch.minimum)
        smax = corners(surf, torch.maximum)
        has_surf = torch.zeros_like(occ)
        for lv in grid.level_set_data.tolist():
            has_surf = has_surf | ((lv >= smin) & (lv <= smax))
        occ = occ & has_surf
    return pack_occupancy_bits(occ)


def _candidate_test(grid: SparseGrid, opt: RenderOptions, candidates: bool):
    """K1's (sigma_thresh, hull test). ``candidates``: every voxel the JAX
    dense walk hands to its samples with vox_ok set, which the udf-var
    terms count even where no sample is taken (all corners present and, but
    for UDF_ALPHA, which has no corner gate, some raw alpha >=
    sigma_thresh); that is the dense walk's voxel list on a UDF grid."""
    if not candidates:
        return opt.sigma_thresh, _hull_test(grid, opt)
    udf_alpha = grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA
    return (-math.inf if udf_alpha else opt.sigma_thresh), False


def occupancy_words(grid: SparseGrid, opt: RenderOptions, candidates: bool = False) -> torch.Tensor:
    """K1: per-voxel occupancy as bit-packed (X-1, Y-1, ceil((Z-1)/32))
    int32 words (``candidates``: see ``_candidate_test``). The kernel on a
    CUDA grid, the plain version on the CPU."""
    _check_supported(grid, opt)
    if not grid.links.is_cuda:
        return _occupancy_words_plain(grid, opt, candidates)
    sigma_thresh, hull = _candidate_test(grid, opt, candidates)
    if grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
        density = torch.amax(grid.density_data.detach()).reshape(1)  # one value for every row
    else:
        density = grid.density_data.detach()[:, 0].contiguous()
    return kernels.occupancy(
        grid.links, density, grid.surface_data.detach().contiguous(), grid.level_set_data,
        sigma_thresh, hull, grid.surface_type,
    )


def voxel_occupancy(grid: SparseGrid, opt: RenderOptions) -> torch.Tensor:
    """Per-voxel bool (X-1, Y-1, Z-1): can this voxel contribute anything?"""
    return unpack_occupancy_bits(occupancy_words(grid, opt), grid.reso[2] - 1)


# ---------------------------------------------------------------------------
# K2: phase A, the exact pool of occupied crossings
# ---------------------------------------------------------------------------

class Pool(NamedTuple):
    """Occupied (ray, voxel) crossings, ray-major and t-ascending.
    ``offsets`` (B+1,) int64: ray r owns entries [offsets[r], offsets[r+1]).
    ``n_occupied`` counts occupied candidates before degenerate slivers
    (far_t <= close_t + 1e-9) are dropped, as the JAX package does."""

    ray_id: torch.Tensor  # (M,) int32
    l: torch.Tensor  # (M, 3) int32
    close_t: torch.Tensor  # (M,)
    far_t: torch.Tensor  # (M,)
    offsets: torch.Tensor  # (B+1,) int64
    n_occupied: torch.Tensor  # (B,) int32


def _snap(o_b, d_b, pb, crossed_at):
    """Coordinate of position pb along axis b: floor(pb), except within
    _SNAP_TOL of a plane q, where ``crossed_at(t_q)`` decides the side, t_q
    being the time the ray crosses q, computed as the candidates' own t's."""
    fl = torch.floor(pb)
    q = torch.round(pb)
    near = torch.abs(pb - q) < _SNAP_TOL
    safe = torch.where(d_b == 0, torch.full_like(d_b, 1e-12), d_b)
    cr = crossed_at((q - o_b) / safe).to(pb.dtype)
    coord = torch.where(d_b > 0, q - 1.0 + cr, q - cr)
    return torch.where(near & (d_b != 0), coord, fl).to(torch.int32)


def _cross_coord(o_b, d_b, t, tie_crossed: bool):
    """Voxel coordinate along a non-crossed axis b for a candidate at time t:
    the corner-crossing guard of the JAX package (surface.py:1404-1433).
    Near a plane the side is decided by comparing crossing times, which is
    exact; exact ties go to ``tie_crossed`` so that one candidate claims the
    diagonal voxel."""
    if tie_crossed:
        return _snap(o_b, d_b, o_b + t * d_b, lambda t_q: t_q <= t)
    return _snap(o_b, d_b, o_b + t * d_b, lambda t_q: t_q < t)


def _entry_candidate(origins, dirs, t_in, slack: float = 1e-9):
    """Voxel at a segment entry (surface.py:1436-1458): planes crossed at or
    before t_in + slack put the entry in the voxel ahead."""
    t = t_in[:, None]
    return torch.cat([
        _snap(origins[:, b : b + 1], dirs[:, b : b + 1], origins[:, b : b + 1] + t * dirs[:, b : b + 1],
              lambda t_q: t_q <= t + slack)
        for b in range(3)
    ], dim=-1)


def _occ_bit_lookup(words: torch.Tensor, lx, ly, lz) -> torch.Tensor:
    W = words.shape[2]
    widx = (lx.long() * words.shape[1] + ly.long()) * W + (lz // 32).long()
    w = words.reshape(-1)[widx]
    return ((w >> (lz & 31)) & 1) == 1


def _compact_crossings_plain(reso, origins, dirs, tnear, tmax, words) -> Pool:
    """Plain version of K2: every candidate (the tnear entry plus each
    interior axis-plane crossing in (tnear, tmax)) names its voxel in closed
    form (surface.py:1652-1734); the occupied ones, ordered by (ray, t),
    minus degenerate slivers, form the pool."""
    B = origins.shape[0]
    dev, dtype = origins.device, origins.dtype
    cand_t = [tnear[:, None]]
    cand_l = [_entry_candidate(origins, dirs, tnear)[:, None, :]]
    cand_ok = [(tmax > tnear + 1e-9)[:, None]]
    for a in range(3):
        planes = torch.arange(1, reso[a] - 1, dtype=dtype, device=dev)
        da = dirs[:, a : a + 1]
        safe = torch.where(da == 0, torch.full_like(da, 1e-12), da)
        t = (planes[None, :] - origins[:, a : a + 1]) / safe
        ok = (da != 0) & (t > tnear[:, None] + 1e-9) & (t < tmax[:, None] - 1e-9)
        ls = []
        for b in range(3):
            if b == a:
                ls.append((planes[None, :] - (da < 0).to(dtype)).to(torch.int32).expand_as(t))
            else:
                ls.append(_cross_coord(origins[:, b : b + 1], dirs[:, b : b + 1], t, b < a))
        cand_t.append(torch.where(ok, t, torch.zeros_like(t)))
        cand_l.append(torch.stack(ls, dim=-1))
        cand_ok.append(ok)
    t_all = torch.cat(cand_t, dim=1)  # (B, C)
    l_all = torch.cat(cand_l, dim=1)  # (B, C, 3)
    ok_all = torch.cat(cand_ok, dim=1)

    hi = torch.tensor([r - 2 for r in reso], dtype=torch.int32, device=dev)
    in_bounds = torch.all(l_all >= 0, dim=-1) & torch.all(l_all <= hi, dim=-1)
    lc = torch.minimum(torch.clamp(l_all, min=0), hi)
    hit = _occ_bit_lookup(words, lc[..., 0], lc[..., 1], lc[..., 2])
    occ_seg = hit & ok_all & in_bounds
    n_occupied = occ_seg.sum(dim=1).to(torch.int32)

    rr, cc = occ_seg.nonzero(as_tuple=True)  # ray-major, candidate order
    t_e = t_all[rr, cc]
    l_e = lc[rr, cc]
    order = torch.sort(t_e, stable=True).indices
    order = order[torch.sort(rr[order], stable=True).indices]
    rr, t_e, l_e = rr[order], t_e[order], l_e[order]
    _, far_slab = dda.voxel_plane_ts(origins[rr], dirs[rr], l_e)
    far_t = torch.minimum(far_slab, tmax[rr])
    keep = far_t > t_e + 1e-9
    rr = rr[keep]
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(rr, minlength=B), dim=0)
    return Pool(rr.to(torch.int32), l_e[keep].contiguous(), t_e[keep], far_t[keep],
                offsets, n_occupied)


def compact_crossings_packed(grid: SparseGrid, origins, dirs, tnear, tmax,
                             words: torch.Tensor) -> Pool:
    """K2: the pool of all occupied crossings, sized exactly, so it never
    overflows (the JAX package's pool budget and its supervoxel prefilter
    are not needed: the set of voxels does not depend on them). ``words``
    are the packed occupancy words of ``occupancy_words``."""
    if not origins.is_cuda:
        return _compact_crossings_plain(grid.reso, origins, dirs, tnear, tmax, words)
    n_occupied, n_valid = kernels.phase_a_count(origins, dirs, tnear, tmax, words, grid.reso)
    offsets = torch.zeros(origins.shape[0] + 1, dtype=torch.int64, device=origins.device)
    torch.cumsum(n_valid, dim=0, out=offsets[1:])
    M = int(offsets[-1])  # the only host sync of a chunk: sizes the pool
    ray_id, l, close_t, far_t = kernels.phase_a_fill(
        origins, dirs, tnear, tmax, words, grid.reso, offsets, M
    )
    return Pool(ray_id, l, close_t, far_t, offsets, n_occupied)


# ---------------------------------------------------------------------------
# K11a: the dense walk's voxel list; K11b: the first K occupied crossings
# ---------------------------------------------------------------------------

def max_voxels_for(grid: SparseGrid) -> int:
    """Bound on the dense walk's DDA steps: a ray crosses at most ~sum(reso)
    planes (surface.py:60-62)."""
    return int(sum(r - 1 for r in grid.reso)) + 2


def _pool_from_lists(B: int, rr, l, close_t, far_t, n_occupied, dev) -> Pool:
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(rr.long(), minlength=B), dim=0)
    return Pool(rr.to(torch.int32), l.contiguous(), close_t, far_t, offsets, n_occupied)


def _dense_walk_plain(reso, origins, dirs, tnear, tmax, ray_ok, words, max_voxels: int):
    """Plain version of K11a: the JAX package's dense DDA walk
    (surface.py:1092-1143) step by step in the rays' own dtype: from tnear,
    ``next_crossing`` gives each step's end, the midpoint voxel is the
    step's voxel, and the walk ends past tmax (``t < tmax - 1e-9`` to take
    a step, ``next_t < tmax + 1e-6`` to go on). Of the voxels walked, the
    in-bounds ones that K1's words mark occupied are kept (the others
    contribute nothing), with their slabs' entry and exit t
    (``voxel_plane_ts``). Returns the pool and each entry's step index."""
    B = origins.shape[0]
    dev = origins.device
    t = torch.where(ray_ok, tnear, torch.zeros_like(tnear))
    alive = ray_ok.clone()
    hi = torch.tensor([r - 2 for r in reso], dtype=torch.int32, device=dev)
    rows, ls, steps = [], [], []
    for step in range(max_voxels):
        if not bool(alive.any()):
            break
        next_t = dda.next_crossing(origins, dirs, t)
        has_next = torch.isfinite(next_t)
        seg_ok = alive & has_next & (t < tmax - 1e-9)
        next_safe = torch.where(has_next, next_t, t + 1.0)
        l, in_bounds = dda.voxel_between(
            origins, dirs, torch.where(seg_ok, t, torch.zeros_like(t)),
            torch.where(seg_ok, next_safe, torch.ones_like(t)), reso)
        lc = torch.minimum(torch.clamp(l, min=0), hi)
        keep = seg_ok & in_bounds & _occ_bit_lookup(words, lc[:, 0], lc[:, 1], lc[:, 2])
        idx = keep.nonzero()[:, 0]
        rows.append(idx)
        ls.append(l[idx])
        steps.append(torch.full_like(idx, step))
        alive = alive & (next_safe < tmax + 1e-6) & has_next
        t = torch.where(seg_ok, next_safe, t)
    if rows:
        rr, l, st = torch.cat(rows), torch.cat(ls), torch.cat(steps)
    else:
        rr = st = torch.zeros(0, dtype=torch.int64, device=dev)
        l = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    order = torch.sort(rr, stable=True).indices  # ray-major, walk order within a ray
    rr, l, st = rr[order], l[order], st[order]
    close_t, far_t = dda.voxel_plane_ts(origins[rr], dirs[rr], l)
    n_occ = torch.bincount(rr, minlength=B).to(torch.int32)
    return _pool_from_lists(B, rr, l, close_t, far_t, n_occ, dev), st


def dense_walk(grid: SparseGrid, origins, dirs, tnear, tmax, ray_ok, words: torch.Tensor,
               max_voxels: int, want_steps: bool = False):
    """K11a: the occupied voxels of the dense walk, a pool as K2's (entries
    ray-major in walk order; close_t and far_t the voxel's slab). K3 and K4
    then run on it as on K2's. ``n_occupied`` counts each ray's entries.
    Returns (pool, steps): with ``want_steps`` each entry's walk step
    (M,) int64, else None."""
    if not origins.is_cuda:
        pool, st = _dense_walk_plain(grid.reso, origins, dirs, tnear, tmax, ray_ok, words,
                                     max_voxels)
        return pool, (st if want_steps else None)
    t0 = torch.where(ray_ok, tnear, torch.zeros_like(tnear))
    n = kernels.dense_walk_count(origins, dirs, t0, tmax, ray_ok, words, grid.reso, max_voxels)
    offsets = torch.zeros(origins.shape[0] + 1, dtype=torch.int64, device=origins.device)
    torch.cumsum(n, dim=0, out=offsets[1:])
    M = int(offsets[-1])  # the host sync that sizes the pool, as K2's
    ray_id, l, close_t, far_t, *st = kernels.dense_walk_fill(
        origins, dirs, t0, tmax, ray_ok, words, grid.reso, max_voxels, offsets, M,
        want_steps=want_steps)
    return Pool(ray_id, l, close_t, far_t, offsets, n), (st[0].long() if want_steps else None)


def _cap_pool(pool: Pool, K: int) -> Pool:
    """The first K entries of each ray of an exact pool."""
    pos = torch.arange(pool.close_t.shape[0], device=pool.offsets.device) - torch.repeat_interleave(
        pool.offsets[:-1], pool.offsets[1:] - pool.offsets[:-1])
    keep = pos < K
    rr = pool.ray_id[keep]
    B = pool.offsets.shape[0] - 1
    n_valid = (pool.offsets[1:] - pool.offsets[:-1]).to(torch.int32)
    return _pool_from_lists(B, rr, pool.l[keep], pool.close_t[keep], pool.far_t[keep], n_valid,
                            pool.offsets.device)


def compact_crossings(grid: SparseGrid, origins, dirs, tnear, tmax, words: torch.Tensor,
                      K: int) -> Pool:
    """K11b: the first K occupied crossings of each ray, in t order, the
    JAX package's ``compact_crossings`` (surface.py:1284-1334) over K2's
    exact candidates. ``n_occupied`` is the uncapped count of occupied,
    non-degenerate crossings (JAX's ``sum(occ_seg)``), which callers
    compare with K to detect overflow."""
    if not origins.is_cuda:
        return _cap_pool(_compact_crossings_plain(grid.reso, origins, dirs, tnear, tmax, words),
                         K)
    _, n_valid = kernels.phase_a_count(origins, dirs, tnear, tmax, words, grid.reso)
    offsets = torch.zeros(origins.shape[0] + 1, dtype=torch.int64, device=origins.device)
    torch.cumsum(torch.clamp(n_valid, max=K), dim=0, out=offsets[1:])
    M = int(offsets[-1])
    ray_id, l, close_t, far_t = kernels.compact_fill(
        origins, dirs, tnear, tmax, words, grid.reso, offsets, M)
    return Pool(ray_id, l, close_t, far_t, offsets, n_valid)


# ---------------------------------------------------------------------------
# K3: phase B, per-entry samples
# ---------------------------------------------------------------------------

def _voxel_samples_T(grid: SparseGrid, opt: RenderOptions, oT, dT, shmT,
                     near_grid_t, lT, close_t, far_t, vox_ok, packed):
    """Plain version of K3, as the JAX package's ``_voxel_samples_T``
    (surface.py:469-734): pool axis M minor; slot axis S leading, S =
    3*n_lv (+1 fake sample) for the scalar fields (SDF and the UDF types,
    whose corner values pass through softplus), 1 for PLANE (one ray-plane
    root, no fake sample) and VOXEL_FACE (one sample at the entry).
    UDF_ALPHA takes a slot's raw alpha from its level set's row of
    ``density_data`` and has no corner-alpha gate.

    :return: dict of (S, M) slot arrays (t, alpha [pre-truncation], contrib,
        fake, counted), (3, S, M) vectors (rgb, snorm, snorm_in), vox_ok,
        surf8T (8, M), n_slots; for the UDF types lv_ok (n_lv, M).
    """
    M = close_t.shape[0]
    dtype = oT.dtype
    stype = grid.surface_type
    n_surf_c = grid.surface_data.shape[1]
    X, Y, Z = grid.reso
    offs = CORNER_OFFSETS

    idx = []
    for c in range(8):
        cx = torch.clamp(lT[0] + int(offs[c, 0]), 0, X - 1).long()
        cy = torch.clamp(lT[1] + int(offs[c, 1]), 0, Y - 1).long()
        cz = torch.clamp(lT[2] + int(offs[c, 2]), 0, Z - 1).long()
        idx.append((cx * Y + cy) * Z + cz)
    links8T = grid.links.reshape(-1)[torch.stack(idx, 0)]  # (8, M)
    vox_ok = vox_ok & torch.all(links8T >= 0, dim=0)

    cap = packed.shape[0]
    rows = packed[torch.clamp(links8T, 0, cap - 1).long()]  # (8, M, C8)
    v8T = rows.permute(0, 2, 1) * (links8T >= 0)[:, None, :].to(dtype)  # (8, C8, M)
    alpha8T = v8T[:, 0, :]
    if stype != defs.SURFACE_TYPE_UDF_ALPHA:
        vox_ok = vox_ok & torch.any(alpha8T >= opt.sigma_thresh, dim=0)
    surf8T = v8T[:, 1, :]
    if stype in UDF_TYPES:
        surf8T = softplus(surf8T)
    fs_std = grid.fake_sample_std[0, 0] if grid.fake_sample_std is not None else 1.0

    bd = grid.basis_dim
    sh_base = 1 + n_surf_c
    corner_rgbT = []  # per channel: (8, M)
    for ch in range(3):
        acc_rgb = None
        for b in range(bd):
            term = v8T[:, sh_base + ch * bd + b, :] * shmT[b][None, :]
            acc_rgb = term if acc_rgb is None else acc_rgb + term
        corner_rgbT.append(acc_rgb)

    if stype == defs.SURFACE_TYPE_VOXEL_FACE:
        # one sample where the ray enters the voxel, alpha the sigmoid of
        # corner 0's raw value, colour at the entry point (surface.py:556-588)
        epos = oT + close_t[None, :] * dT
        gszT = torch.tensor(grid.reso, dtype=dtype, device=oT.device)[:, None]
        inside = torch.all(epos >= 1e-6, dim=0) & torch.all(epos <= gszT - 1.0 - 1e-6, dim=0)
        efrac = epos - lT.to(dtype)
        efrac = _clip(torch.where(vox_ok[None], efrac, torch.full_like(efrac, 0.5)), 0.0, 1.0)
        ew8 = trilerp_weights_T(efrac)
        ergb = torch.stack([_clip(_sum0(ew8 * corner_rgbT[ch]) + 0.5, lo=0.0) for ch in range(3)],
                           dim=0)
        contrib = vox_ok & inside & (close_t >= near_grid_t)
        zero3 = torch.zeros((3, 1, M), dtype=dtype, device=oT.device)
        return {
            "t": close_t[None, :],
            "alpha": torch.sigmoid(alpha8T[0])[None, :],
            "rgb": ergb[:, None, :],
            "contrib": contrib[None, :],
            "fake": torch.zeros_like(contrib)[None, :],
            "snorm": zero3,
            "snorm_in": zero3,
            "counted": contrib[None, :].to(torch.int32),
            "vox_ok": vox_ok,
            "surf8T": surf8T,
            "n_slots": 1,
        }

    lv_ok_list = None
    if stype == defs.SURFACE_TYPE_PLANE:
        # the mean of the 8 corner planes (a, b, c, d), d clamped to +-0.3
        # about the voxel centre, one root in global grid coordinates
        # (surface.py:590-606)
        plane = _sum0(v8T[:, 1:5, :]) / 8.0  # (4, M)
        abc = plane[:3]
        xyz_term = _sum0((lT.to(dtype) + 0.5) * abc)
        th = 0.3
        dpl = torch.minimum(torch.maximum(plane[3], -th - xyz_term), th - xyz_term)
        denom = _sum0(abc * dT)
        denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
        t_pl = -(_sum0(abc * oT) + dpl) / denom
        roots = (t_pl - close_t)[None, :]  # (1, M)
        lv_ok_s = vox_ok[None, :] & (t_pl[None, :] > 0)
        vox_has_surf = vox_ok
        root_pos = roots > -1e-6
    else:
        smin = torch.amin(surf8T, dim=0)
        smax = torch.amax(surf8T, dim=0)
        f0, f1, f2, f3 = cubic_coeffs_T(surf8T, oT + close_t[None, :] * dT - lT.to(dtype), dT)
        root_chunks, lv_ok_list = [], []
        for lv in grid.level_set_data:
            lv_ok = vox_ok & (lv >= smin) & (lv <= smax)
            lv_ok_list.append(lv_ok)
            root_chunks.append(cubic_roots_T(f0 - lv, f1, f2, f3))  # (3, M)
        roots = torch.cat(root_chunks, dim=0)  # (S0, M)
        lv_ok_s = torch.cat([g[None, :].expand(3, M) for g in lv_ok_list], dim=0)
        vox_has_surf = torch.any(torch.stack(lv_ok_list, 0), dim=0)
        root_pos = roots > 0

    t_real = close_t[None, :] + roots  # (S0, M)
    frac = oT[:, None, :] + t_real[None, :, :] * dT[:, None, :] - lT[:, None, :].to(dtype)
    in_cube = torch.all(frac >= 0, dim=0) & torch.all(frac <= 1, dim=0)
    geo_ok = lv_ok_s & root_pos & in_cube & (t_real >= near_grid_t)
    vox_has_sample = torch.any(geo_ok, dim=0)
    frac_safe = _clip(torch.where(geo_ok[None], frac, torch.full_like(frac, 0.5)), 0.0, 1.0)
    if stype == defs.SURFACE_TYPE_PLANE:
        sgrad = abc[:, None, :].expand_as(frac_safe)  # the plane's normal
    else:
        sgrad = trilerp_field_grad_T(surf8T[:, None, :], frac_safe)
    if opt.only_outward_intersect:
        geo_ok = geo_ok & (_sum0(sgrad * dT[:, None, :]) > 0)
    nsq = _sum0(sgrad * sgrad)[None]
    snorm_s = -sgrad / torch.sqrt(torch.where(nsq > 1e-20, nsq, torch.full_like(nsq, 1e-20)))

    w8 = trilerp_weights_T(frac_safe)  # (8, S0, M)
    if stype == defs.SURFACE_TYPE_UDF_ALPHA:
        # the alpha of each slot's level set (surface.py:646-650)
        raw_a = grid.density_data[:, 0].repeat_interleave(3)[:, None].expand(-1, M)
    else:
        raw_a = _sum0(w8 * alpha8T[:, None, :])
    w8_sh = trilerp_weights_T(frac_safe.detach()) if opt.no_surf_grad_from_sh else w8
    rgb_s = torch.stack(
        [_clip(_sum0(w8_sh * corner_rgbT[ch][:, None, :]) + 0.5, lo=0.0) for ch in range(3)],
        dim=0,
    )  # (3, S0, M)
    contrib = geo_ok & (raw_a > opt.sigma_thresh)
    alpha_s = surf_alpha_act(raw_a, opt.alpha_activation_type)
    t_s = t_real
    fake_s = torch.zeros_like(contrib)
    counted = geo_ok
    snorm_in = snorm_s

    if opt.surf_fake_sample and stype != defs.SURFACE_TYPE_PLANE:
        # fake sample at mid-segment with a Gaussian reweight
        # (surf_trav.cu:423-541), appended as the entry's last slot
        take = vox_ok & ~vox_has_sample & ((far_t - close_t) > opt.surf_fake_sample_min_vox_len)
        if opt.limited_fake_sample:
            take = take & vox_has_surf
        tf = 0.5 * (close_t + far_t)
        ffrac = oT + tf[None, :] * dT - lT.to(dtype)
        ffrac = _clip(torch.where(take[None], ffrac, torch.full_like(ffrac, 0.5)), 0.0, 1.0)
        fw8 = trilerp_weights_T(ffrac)
        fraw = _sum0(fw8 * alpha8T)
        frgb = torch.stack(
            [_clip(_sum0(fw8 * corner_rgbT[ch]) + 0.5, lo=0.0) for ch in range(3)], dim=0
        )
        mu = _sum0(surf8T) / 8.0
        dev_ = surf8T - mu[None, :]
        var = _sum0(dev_ * dev_) / 8.0
        std = torch.sqrt(_clip(var, lo=1e-9))
        if not opt.fake_sample_normalize_surf:
            std = torch.ones_like(std)
        s_norm = _sum0(fw8 * (surf8T / std[None, :]))
        dists = s_norm[None, :] - grid.level_set_data[:, None]  # (n_lv, M)
        amin = torch.argmin(torch.abs(dists), dim=0)
        fake_dist = torch.gather(dists, 0, amin[None, :])[0]
        if stype == defs.SURFACE_TYPE_UDF_ALPHA:
            fraw = grid.density_data[:, 0][amin]  # the nearest level set's alpha
        take = take & (fraw > opt.sigma_thresh)
        falpha = surf_alpha_act(fraw, opt.alpha_activation_type)
        q = fake_dist / fs_std
        falpha = falpha * torch.exp(-0.5 * (q * q))
        t_s = torch.cat([t_s, tf[None, :]], dim=0)
        alpha_s = torch.cat([alpha_s, falpha[None, :]], dim=0)
        rgb_s = torch.cat([rgb_s, frgb[:, None, :]], dim=1)
        contrib = torch.cat([contrib, take[None, :]], dim=0)
        fake_s = torch.cat([fake_s, torch.ones_like(take)[None, :]], dim=0)
        fgrad = trilerp_field_grad_T(surf8T, ffrac)
        fnsq = _sum0(fgrad * fgrad)[None]
        fsnorm = -fgrad / torch.sqrt(torch.where(fnsq > 1e-20, fnsq, torch.full_like(fnsq, 1e-20)))
        snorm_in = torch.cat([snorm_s, fsnorm[:, None, :]], dim=1)
        snorm_s = torch.cat([snorm_s, torch.zeros_like(fsnorm)[:, None, :]], dim=1)
        counted = torch.cat([counted, torch.zeros_like(take)[None, :]], dim=0)

    out = {
        "t": t_s,
        "alpha": alpha_s,  # pre-truncation
        "rgb": rgb_s,
        "contrib": contrib,
        "fake": fake_s,
        "snorm": snorm_s,
        "snorm_in": snorm_in,
        "counted": counted.to(torch.int32),
        "vox_ok": vox_ok,
        "surf8T": surf8T,
        "n_slots": contrib.shape[0],
    }
    if stype in UDF_TYPES:
        out["lv_ok"] = torch.stack(lv_ok_list, 0)  # (n_lv, M)
    return out


def _accumulate_sample_losses_T(grid: SparseGrid, opt: RenderOptions, dT, smp: dict) -> dict:
    """Per-entry inward-norm and density-lap sums over the slots and, for
    the UDF types, the udf-var terms, as the JAX package's
    ``_accumulate_sample_losses_T`` (surface.py:737-770): (M,) each, keyed
    as the ray losses."""
    contrib = smp["contrib"]
    alpha_pre = smp["alpha"]
    zero = torch.zeros_like(alpha_pre)
    in_dot = _sum0(smp["snorm_in"].detach() * dT[:, None, :])  # normals detached
    in_pos = torch.clamp(in_dot, min=0.0)
    acc = {"l_inward": _sum0(torch.where(contrib, alpha_pre * (in_pos * in_pos), zero))}
    p_lap = torch.exp(-alpha_pre) + torch.exp(-(1.0 - alpha_pre))
    acc["lap_sum"] = _sum0(torch.where(contrib, -torch.log(p_lap), zero))
    acc["lap_cnt"] = _sum0(contrib.to(alpha_pre.dtype))
    if grid.surface_type in UDF_TYPES:
        # clamp(n_lv_in_hull - 1, 0) * var(8 corners, unbiased) over the
        # candidate voxels (svox2.py:2597-2606)
        vox_ok, surf8T = smp["vox_ok"], smp["surf8T"]
        dtype = surf8T.dtype
        if opt.surf_fake_sample and not opt.limited_fake_sample:
            n_lv = float(grid.level_set_data.shape[0])
            n_hull = torch.where(vox_ok, torch.full_like(surf8T[0], n_lv),
                                 torch.zeros_like(surf8T[0]))
        else:
            n_hull = _sum0(smp["lv_ok"].to(dtype))
            if grid.surface_type == defs.SURFACE_TYPE_UDF_FAKE_SAMPLE:
                n_hull = torch.clamp(n_hull, min=1.0)
        mu = _sum0(surf8T) / 8.0
        dev_ = surf8T - mu[None, :]
        var = _sum0(dev_ * dev_) / 7.0
        acc["udf_var_sum"] = torch.where(vox_ok, torch.clamp(n_hull - 1.0, min=0.0) * var,
                                         torch.zeros_like(var))
        acc["udf_var_cnt"] = vox_ok.to(dtype)
    return acc


def _voxel_samples_plain(grid, opt, pool: Pool, origins, dirs, sh_mult, near_grid_t, packed):
    rid = pool.ray_id.long()
    dT = dirs[rid].T
    smp = _voxel_samples_T(
        grid, opt, origins[rid].T, dT, sh_mult[rid].T, near_grid_t,
        pool.l.T, pool.close_t, pool.far_t,
        torch.ones_like(pool.close_t, dtype=torch.bool), packed,
    )
    acc = _accumulate_sample_losses_T(grid, opt, dT, smp)
    smp["loss_e"] = torch.stack([acc[k] for k in _LOSS_E_KEYS if k in acc], 0)
    return smp


def voxel_samples(grid: SparseGrid, opt: RenderOptions, pool: Pool, origins, dirs,
                  sh_mult, near_grid_t: float, packed) -> dict:
    """K3: per pool entry the (S0, M) slot arrays t, alpha (pre-truncation),
    contrib, fake, counted; (3, S0, M) rgb and snorm; and ``loss_e`` (3, M),
    the entry's inward-norm, density-lap and lap-count sums, with the UDF
    types' udf-var sum and count (5, M)."""
    if not origins.is_cuda:
        return _voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult, near_grid_t, packed)
    return kernels.phase_b(
        pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs, sh_mult,
        grid.links, packed, _surface_spec(grid), grid.level_set_data,
        near_grid_t, _fss(grid), opt,
    )


def _fss(grid: SparseGrid):
    """The grid's fake_sample_std as the kernels read it (None: 1)."""
    return None if grid.fake_sample_std is None else grid.fake_sample_std.detach()


def _surface_spec(grid: SparseGrid) -> kernels.SurfaceSpec:
    """What K3 and K5b need to know of the grid's surface type: its type,
    the surface channels of a row, and UDF_ALPHA's per-level-set alphas."""
    table = None
    if grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
        table = grid.density_data.detach()[:, 0].contiguous()
    return kernels.SurfaceSpec(grid.surface_type, grid.surface_data.shape[1], table)


# ---------------------------------------------------------------------------
# K4: compositor
# ---------------------------------------------------------------------------

def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix along dim 1 (a shifted inclusive scan, so each
    prefix is a running sum and never a difference of two sums)."""
    inc = torch.cumsum(x, dim=1)
    return torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], dim=1)


def _count_window(alive: torch.Tensor, window: int) -> torch.Tensor:
    """(B, E) bool: which entries count toward ``n_intersections`` and the
    inward/lap sums under stop_thresh. The JAX package's walks process
    ``window`` entries a pass (1 for the dense walk, ``voxel_chunk`` for the
    compact renderer) and count every sample of a pass that starts alive,
    even past the entry that kills the ray; the packed compositor
    (``window`` 0) counts every entry. ``alive`` is the entry kill."""
    B, E = alive.shape
    if window <= 0:
        return torch.ones_like(alive)
    start = (torch.arange(E, device=alive.device) // window) * window
    return alive[:, start] | (start == 0)[None, :]


def _cache_plain(K: int, contrib, t, alpha_c, weight, fake) -> dict:
    """The first-K sample cache of the JAX package (surface.py:104-118,
    951-970, 1955-1975): per ray the first K contributing samples in
    (entry, slot) order, written into zeros by a scatter-add."""
    B = t.shape[0]
    ci = contrib.to(torch.int64)
    idx = _excl_cumsum(ci)
    ok = contrib & (idx < K)
    rows = torch.arange(B, device=t.device)[:, None].expand_as(idx)
    flat = torch.where(ok, rows * K + idx, torch.full_like(idx, B * K)).reshape(-1)

    def scat(vals):
        buf = vals.new_zeros(B * K + 1)
        buf = buf.index_add(0, flat, torch.where(ok, vals, torch.zeros_like(vals)).reshape(-1))
        return buf[:-1].reshape(B, K)

    zero = torch.zeros_like(t)
    return {
        "ts": scat(t),
        "alphas": scat(alpha_c),
        "weights": scat(weight),
        "fake_mask": scat(torch.where(fake, zero + 1.0, zero)).detach() > 0,
        "n_cached": torch.clamp(ci.sum(dim=1), max=K).to(torch.int32),
    }


def cache_depth_med(cache: dict) -> torch.Tensor:
    """Median depth from the first-K cache (surface.py:1032-1051): t where
    the running cached weight first reaches half the cached total; 0 where
    none does. Differentiable in the cached t, as JAX's take_along_axis
    (the weights only select the column)."""
    cw = cache["weights"].detach()
    cum = torch.cumsum(cw, dim=1)
    target = 0.5 * cum[:, -1:]
    crossed = cum >= torch.clamp(target, min=1e-12)
    idx = torch.argmax(crossed.to(torch.int8), dim=1)
    has = torch.any(crossed, dim=1) & (cum[:, -1] > 0)
    t = torch.gather(cache["ts"], 1, idx[:, None])[:, 0]
    return torch.where(has, t, torch.zeros_like(t))


def _composite_plain(opt: RenderOptions, trunc_a, offsets, smp, sig_thresh=None,
                     window: int = 0, mode_first: bool = False, cache_size=None,
                     bg_rgb=None) -> dict:
    """Plain version of K4, the compositor of the JAX package
    ``volume_render_surface_packed`` (surface.py:1804-1953). The pool is
    laid out per ray, (B, E*S0) in (entry, slot) order, so every per-ray
    prefix is a segmented scan: no global cumsum minus a per-ray base, which
    cancels badly in float32. ``window`` (``_count_window``), ``mode_first``
    (the mode depth at the first max-weight sample, the rule of the JAX
    walks' ``_voxel_pass``) and ``cache_size`` (K11c, the first-K cache) give
    the dense and compact renderers' semantics. ``bg_rgb`` (B, 3), the
    background colour of ``render.background.background_color``, takes the
    place of the brightness."""
    B = offsets.shape[0] - 1
    S0, M = smp["t"].shape
    dev = offsets.device
    dtype = smp["t"].dtype
    n_e = offsets[1:] - offsets[:-1]
    E = max(int(n_e.max()) if B > 0 and M > 0 else 0, 1)  # >= 1 padded entry
    ray = torch.repeat_interleave(torch.arange(B, device=dev), n_e)
    pos = torch.arange(M, device=dev) - offsets[ray]

    def dense(x):  # (S0, M) -> (B, E, S0), zero-padded
        out = torch.zeros((B, E, S0), dtype=x.dtype, device=dev)
        out[ray, pos] = x.T
        return out

    L = E * S0
    t3 = dense(smp["t"])
    t = t3.reshape(B, L)
    alpha = dense(smp["alpha"]).reshape(B, L)
    contrib = dense(smp["contrib"]).reshape(B, L)
    fake = dense(smp["fake"]).reshape(B, L)
    counted = dense(smp["counted"]).reshape(B, L)
    zero = torch.zeros_like(t)

    exc_cnt = _excl_cumsum(counted)
    if opt.truncated_vol_render:
        ids = exc_cnt - fake.to(exc_cnt.dtype)
        alpha_trunc = alpha * trunc_vol_render_rw(ids, trunc_a, opt.trunc_vol_weight_min)
    else:
        alpha_trunc = alpha

    lo, hi = 1e-7, 1.0 - 1e-7
    win = torch.ones((B, E), dtype=torch.bool, device=dev)
    if opt.stop_thresh > 0:
        # voxel-entry transmittance kill: a whole entry goes once the
        # transmittance at its entry is below stop_thresh
        one_m0 = torch.where(
            contrib, torch.clamp(1.0 - torch.where(contrib, alpha_trunc, zero), lo, hi), zero + 1.0)
        la_e = torch.log(one_m0).reshape(B, E, S0).sum(dim=2)
        alive = _excl_cumsum(la_e) > math.log(opt.stop_thresh)  # (B, E)
        contrib = contrib & alive[:, :, None].expand(B, E, S0).reshape(B, L)
        win = _count_window(alive, window)
    cnt = (counted * win[:, :, None].expand(B, E, S0).reshape(B, L)).sum(dim=1).to(torch.int32)

    alpha_c = torch.where(contrib, alpha_trunc, zero)
    one_m = torch.where(contrib, _clip(1.0 - alpha_c, lo, hi), zero + 1.0)
    log_att = torch.log(one_m)
    pre_att = _excl_cumsum(log_att)
    log_T = log_att.sum(dim=1)
    weight = torch.where(contrib, torch.exp(_clip(pre_att, hi=0.0)) * (1.0 - one_m), zero)

    def dense_vec(x):  # (3, S0, M) -> (3, B, L)
        return torch.stack([dense(x[c]).reshape(B, L) for c in range(3)], 0)

    rgb_acc = (weight[None] * dense_vec(smp["rgb"])).sum(dim=2).T
    depth = (weight * t).sum(dim=1)
    normal = (weight[None] * dense_vec(smp["snorm"])).sum(dim=2).T

    w3 = weight.reshape(B, E, S0)
    if mode_first:
        # the first sample holding the ray's max weight, if that is > 0
        wmax, arg = torch.max(weight, dim=1)
        t_at = torch.gather(t, 1, arg[:, None])[:, 0]
        t_mode = torch.where(wmax > 0, t_at, torch.zeros_like(t_at))
    else:
        # largest t among the entries whose (first) max-weight slot holds
        # the ray's max weight
        w_best, arg = torch.max(w3, dim=2)  # first max-weight slot of each entry
        t_best = torch.gather(t3, 2, arg[..., None])[..., 0]
        wmax = torch.clamp(w_best.amax(dim=1), min=0.0)
        is_best = (w_best >= wmax[:, None]) & (w_best > 0)
        t_mode = torch.where(is_best, t_best, torch.full_like(t_best, -math.inf)).amax(dim=1)
        t_mode = torch.where(torch.isfinite(t_mode), t_mode, torch.zeros_like(t_mode))

    # median depth: the smallest t where the running weight reaches half
    preW = _excl_cumsum(weight)
    totW = weight.sum(dim=1, keepdim=True)
    med_hit = contrib & ((preW + weight) >= 0.5 * totW) & (totW > 1e-12)
    t_med = torch.where(med_hit, t, zero + math.inf).amin(dim=1)
    t_med = torch.where(torch.isfinite(t_med), t_med, torch.zeros_like(t_med))

    out = {}
    if sig_thresh is not None:
        # sigma-thresh depth: the first real sample whose pre-truncation
        # alpha passes the threshold (trace_ray_sigma_thresh)
        st_hit = contrib & ~fake & (alpha > sig_thresh)
        t_sig = torch.where(st_hit, t, zero + math.inf).amin(dim=1)
        out["depth_sigma_thresh"] = torch.where(torch.isfinite(t_sig), t_sig,
                                                torch.zeros_like(t_sig))
    if cache_size is not None:
        cache = _cache_plain(cache_size, contrib, t, alpha_c, weight, fake)
        out["cache"] = cache
        out["cache_med"] = cache_depth_med(cache)

    # streaming losses
    inc = contrib if opt.fake_sample_l_dist else contrib & ~fake
    a_i = torch.where(inc, alpha_c, zero)
    w_i = torch.where(inc, weight, zero)
    l_dist_a = (a_i * (t * _excl_cumsum(a_i) - _excl_cumsum(a_i * t))).sum(dim=1)
    l_dist = (w_i * (t * _excl_cumsum(w_i) - _excl_cumsum(w_i * t))).sum(dim=1)

    def entropy(x):
        return torch.where(x > 0, -x * torch.log(_clip(x, lo=1e-8)), zero).sum(dim=1)

    logsig = torch.where(
        contrib,
        torch.log(_clip(-torch.log(_clip(1.0 - alpha_c, lo=1e-8)), lo=1e-8)),
        zero,
    )
    w_sg = torch.where(contrib, weight, zero).detach()  # weights detached (surface.py:1941)
    win_e = win[ray, pos]
    loss_e_in = torch.where(win_e[None, :], smp["loss_e"], torch.zeros_like(smp["loss_e"]))
    loss_e = torch.zeros((5, B), dtype=dtype, device=dev)
    loss_e[:loss_e_in.shape[0]].index_add_(1, ray, loss_e_in)
    losses = [
        l_dist, l_dist_a, entropy(w_i), entropy(a_i),
        logsig.sum(dim=1), (logsig * w_sg).sum(dim=1), w_sg.sum(dim=1),
        *loss_e,
    ]
    return {
        **out,
        "live": contrib.reshape(B, E, S0)[ray, pos].T,
        "live_alpha": alpha_c.reshape(B, E, S0)[ray, pos].T,
        "rgb": rgb_acc + torch.exp(log_T)[:, None] * (
            opt.background_brightness if bg_rgb is None else bg_rgb),
        "depth": depth,
        "normal": normal,
        "log_T": log_T,
        "depth_mode": t_mode,
        "depth_med": t_med,
        "n_intersections": cnt,
        "ray_losses": torch.stack(losses, 0),
        "weight": w3[ray, pos].T,
    }


RENDERERS = ("packed", "compact", "dense")  # the JAX package's renderer names


class _Mode(NamedTuple):
    """The compositor's rules for one renderer: the stop_thresh counting
    window (``_count_window``), first-max mode depth, and the cache size."""

    window: int = 0
    mode_first: bool = False
    cache_size: int | None = None


PACKED = _Mode()


def composite(grid: SparseGrid, opt: RenderOptions, offsets: torch.Tensor, smp: dict,
              sig_thresh: float | None = None, want_live: bool = False,
              mode: _Mode = PACKED, bg_rgb=None, want_live_alpha: bool = False) -> dict:
    """K4: per-ray compositing of the (S0, M) slot arrays in (entry, slot)
    order. Returns rgb (with the background), depth, normal, log_T,
    depth_mode, depth_med, n_intersections, ray_losses (12, B) in
    ``_RAY_LOSS_KEYS`` order and the (S0, M) sample weights; with
    ``sig_thresh`` the sigma-thresh depth ``depth_sigma_thresh`` (B,), with
    ``want_live`` (always on the CPU) the (S0, M) flags ``live`` of the
    samples that contribute after the stop_thresh kill, with
    ``want_live_alpha`` (always on the CPU) also ``live_alpha``, their
    truncated alpha (0 elsewhere); with ``mode.cache_size`` (K11c) the
    first-K ``cache`` and its median ``cache_med``. ``bg_rgb`` (B, 3), K13's
    per-ray background colour, takes the place of the brightness."""
    trunc_a = grid.truncated_vol_render_a
    if not offsets.is_cuda:
        return _composite_plain(opt, trunc_a, offsets, smp, sig_thresh, *mode, bg_rgb=bg_rgb)
    return kernels.composite(offsets, smp, trunc_a, opt, sig_thresh, want_live, *mode,
                             bg_rgb=bg_rgb, want_live_alpha=want_live_alpha)


def _grid2world(grid: SparseGrid) -> tuple:
    """grid2world's per-axis scale and offset, as lists of 3 floats."""
    return (2.0 * grid.radius / grid.gsz).tolist(), (-grid.radius + grid.center).tolist()


def _slot_points(grid: SparseGrid, pool: Pool, origins, dirs, t) -> torch.Tensor:
    """The world point (M * S0, 3) of every slot of every pool entry,
    entry-major: ``intersect_points`` on the card, autograd-differentiable
    torch ops on the CPU."""
    if t.is_cuda:
        return kernels.intersect_points(pool.ray_id, t.detach().contiguous(),
                                        origins.contiguous(), dirs.contiguous(),
                                        *_grid2world(grid))
    rid = pool.ray_id.long()
    pts_grid = origins[rid].T[:, None, :] + t[None] * dirs[rid].T[:, None, :]  # (3, S0, M)
    return grid.grid2world(pts_grid.permute(2, 1, 0).reshape(-1, 3))


def _slot_outputs(slots: dict, want_live: bool, want_samples: bool) -> dict:
    """The per-slot outputs of a render from its (S0, M) slot arrays (t, the
    pre-truncation alpha, weight, live, live_alpha, fake and, with
    ``want_live``, the points): the intersection cloud of the JAX package's
    ``return_intersections`` (svox2.py:2746-2761: per slot of every pool
    entry, entry-major, the world point, the pre-truncation alpha, the
    weight and whether it is a real sample that contributes) and the
    samples of its walks' ``return_samples`` (surface.py:1052-1062), per
    slot before the walks' layout. Both carry gradients where JAX's do."""
    out = {}
    if want_live:
        live, fake = slots["live"], slots["fake"]
        out["intersections"] = {
            "pts": slots["pts"],
            "alpha": slots["alpha"].T.reshape(-1),
            "weight": slots["weight"].T.reshape(-1),
            "mask": (live & ~fake).T.reshape(-1),
        }
    if want_samples:
        t, live, fake = slots["t"], slots["live"], slots["fake"]
        out["samples"] = {
            "ts": torch.where(live, t, torch.zeros_like(t)),
            "alphas": slots["live_alpha"],
            "weights": slots["weight"],
            "fake_mask": fake & live,
            "valid": live,
        }
    return out


# ---------------------------------------------------------------------------
# K5: the backward on the card
# ---------------------------------------------------------------------------

class _Chunk(NamedTuple):
    """What a chunk's forward and backward share besides the parameters."""

    grid: SparseGrid
    opt: RenderOptions
    pool: Pool
    origins: torch.Tensor
    dirs: torch.Tensor
    sh_mult: torch.Tensor
    near_grid_t: float
    packed: torch.Tensor
    mode: _Mode
    sig_thresh: float | None = None
    want_live: bool = False
    want_samples: bool = False


# the outputs of _SurfaceFn: per ray, then per slot (S0, M) (``pts`` (M S0,
# 3)), then the cache's (B, K) and its median; an output the chunk does not
# ask for is an empty stand-in
_FN_OUTPUTS = ("rgb", "ray_losses", "depth", "normal", "log_T", "depth_mode", "depth_med",
               "depth_sigma_thresh", "n_intersections",
               "t", "alpha", "weight", "live_alpha", "pts", "live", "fake")
_CACHE_DIFF = ("ts", "alphas", "weights")
_CACHE_KEYS = _CACHE_DIFF + ("fake_mask", "n_cached", "cache_med")
_NON_DIFF = ("n_intersections", "live", "fake", "fake_mask", "n_cached")


class _SurfaceFn(torch.autograd.Function):
    """K3 and K4 forward; K5 backward into density, surface, SH and
    fake_sample_std, into the per-ray background colour ``bg_rgb`` (K13's,
    or None) and into the per-ray basis ``sh_mult`` (the chunk holds its
    detached copy; its gradient reaches a learned basis). Every output that
    carries a gradient in the JAX package takes a cotangent: ``rgb`` and
    ``ray_losses`` through K5a's rgb-only instantiation when they are all;
    with depth, normal, log_T, the mode, median and sigma-thresh depths,
    the slots' t, alphas and weights (the intersections and samples) or
    the cache's median, through K5a's second instantiation (and, for a
    normal's, K5b's), counted as ``backward_ray_out`` and
    ``backward_entry_out``."""

    @staticmethod
    def forward(ctx, density, surface, sh, fss, bg_rgb, sh_mult, chunk: _Chunk):
        c = chunk
        smp = voxel_samples(c.grid, c.opt, c.pool, c.origins, c.dirs, c.sh_mult, c.near_grid_t,
                            c.packed)
        bg_rgb = None if bg_rgb is None else bg_rgb.detach().contiguous()
        comp = composite(c.grid, c.opt, c.pool.offsets, smp, c.sig_thresh,
                         c.want_live or c.want_samples, c.mode, bg_rgb,
                         want_live_alpha=c.want_samples)
        # detached aliases: an output kept on ctx would make a reference
        # cycle (output -> grad_fn -> ctx -> output) that holds the chunk
        # until Python's cycle collector runs
        ctx.chunk, ctx.win = chunk, comp.get("win")
        ctx.smp = {k: v.detach() if torch.is_tensor(v) else v for k, v in smp.items()}
        ctx.bg_rgb, ctx.log_T = bg_rgb, comp["log_T"].detach()
        ctx.set_materialize_grads(False)
        res = dict(comp, t=smp["t"], alpha=smp["alpha"], fake=smp["fake"])
        if c.want_live:
            res["pts"] = _slot_points(c.grid, c.pool, c.origins, c.dirs, smp["t"])
        if comp.get("cache") is not None:
            res.update(comp["cache"], cache_med=comp["cache_med"])
        empty = comp["depth"].new_zeros(0)
        keys = _FN_OUTPUTS + _CACHE_KEYS
        out = tuple(res.get(k, empty) for k in keys)
        ctx.mark_non_differentiable(*(x for k, x in zip(keys, out) if k in _NON_DIFF))
        return out

    @staticmethod
    def backward(ctx, *grads):
        c, smp = ctx.chunk, ctx.smp
        g = {k: None if x is None or x.numel() == 0 else x.contiguous()
             for k, x in zip(_FN_OUTPUTS + _CACHE_KEYS, grads)}
        B = c.origins.shape[0]
        f32 = dict(dtype=torch.float32, device=c.origins.device)
        g_rgb = torch.zeros((B, 3), **f32) if g["rgb"] is None else g["rgb"]
        g_rl = torch.zeros((12, B), **f32) if g["ray_losses"] is None else g["ray_losses"]
        K = c.mode.cache_size
        g_c = None
        if K is not None and any(g[k] is not None for k in _CACHE_DIFF + ("cache_med",)):
            g_c = tuple(torch.zeros((B, K), **f32) if g[k] is None else g[k]
                        for k in _CACHE_DIFF)
        out = kernels.OutCotangents(
            depth=g["depth"], normal=g["normal"], log_T=g["log_T"], mode=g["depth_mode"],
            med=g["depth_med"], cache_med=g["cache_med"], sig=g["depth_sigma_thresh"],
            pts=g["pts"], t=g["t"], alpha=g["alpha"], weight=g["weight"],
            live_alpha=g["live_alpha"])
        d_alpha, d_t, d_col, *d_snorm = kernels.backward_ray(
            c.pool.offsets, smp, c.grid.truncated_vol_render_a, c.opt, g_rgb, g_rl, g_c,
            bg_rgb=ctx.bg_rgb, out=None if all(x is None for x in out) else out,
            mode_first=c.mode.mode_first, sig_thresh=c.sig_thresh,
            rscaling=_grid2world(c.grid)[0] if g["pts"] is not None else None, dirs=c.dirs)
        need = ctx.needs_input_grad
        g_density, g_surface, g_sh, g_fss, *g_shm = kernels.backward_entry(
            c.pool.ray_id, c.pool.l, c.pool.close_t, c.pool.far_t, c.origins, c.dirs, c.sh_mult,
            c.grid.links, c.packed, _surface_spec(c.grid), c.grid.level_set_data,
            c.near_grid_t, _fss(c.grid), c.opt, smp["contrib"], d_alpha, d_t, d_col, g_rl,
            ctx.win, want_sh_mult=need[5], d_snorm=d_snorm[0] if d_snorm else None)
        g_bg = g_rgb * torch.exp(ctx.log_T)[:, None] if need[4] else None
        return (g_density[:, None] if need[0] else None, g_surface if need[1] else None,
                g_sh if need[2] else None, g_fss.reshape(1, 1) if need[3] else None, g_bg,
                g_shm[0] if need[5] else None, None)


# ---------------------------------------------------------------------------
# The renderers
# ---------------------------------------------------------------------------

def _render_plain(grid, opt, pool, origins, dirs, sh_mult, near_grid_t, packed,
                  mode: _Mode = PACKED, bg_rgb=None) -> dict:
    """K3 and K4's plain versions on one pool; differentiable by autograd."""
    smp = _voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult, near_grid_t, packed)
    return _composite_plain(opt, grid.truncated_vol_render_a, pool.offsets, smp, None, *mode,
                            bg_rgb=bg_rgb)


def _finalize(comp: dict, mode: _Mode, cache_med_depth: bool, bg=None) -> dict:
    """Output dict of a renderer from the compositor's per-ray values (the
    background is already added by the compositor). ``cache_med_depth``:
    ``depth_med`` is the cache's median (the dense and compact renderers,
    which have none without a cache); otherwise the cache-free median (the
    packed renderer, surface.py:1996). With a background (``bg``, the pair of
    ``background_color``), ``log_transmit`` includes its log_T_bg and
    ``alpha`` stays the foreground's (surface.py:1012-1024)."""
    log_T = comp["log_T"]
    out = {
        "rgb": comp["rgb"],
        "depth": comp["depth"],
        "depth_mode": comp["depth_mode"],
        "normal": comp["normal"],
        "alpha": 1.0 - torch.exp(log_T),
        "log_transmit": log_T if bg is None else log_T + bg[1],
        "n_intersections": comp["n_intersections"],
        "ray_losses": dict(zip(_RAY_LOSS_KEYS, comp["ray_losses"])),
    }
    if mode.cache_size is not None:
        out["cache"] = comp["cache"]
    if not cache_med_depth:
        out["depth_med"] = comp["depth_med"]
    elif mode.cache_size is not None:
        out["depth_med"] = comp["cache_med"]
    return out


def _render_pool(grid, opt, prep, pool, mode: _Mode, packed, sig_thresh=None,
                 want_live: bool = False, bg=None, want_samples: bool = False) -> dict:
    """K3 and K4 (K5 under a gradient on the card, autograd of the plain
    versions on the CPU) on a pool, composited over the background ``bg``
    (``background_color``'s pair, or None: the brightness). Returns the
    compositor's outputs, with the ``intersections`` (``want_live``) and
    per-slot ``samples`` (``want_samples``) of ``_slot_outputs``."""
    origins, dirs, sh_mult, near_grid_t = prep
    bg_rgb = None if bg is None else bg[0]
    params = (grid.density_data, grid.surface_data, grid.sh_data, grid.fake_sample_std)
    train = torch.is_grad_enabled() and (any(p is not None and p.requires_grad for p in params)
                                         or sh_mult.requires_grad)
    autograd = train and not origins.is_cuda  # K5 differentiates on the card
    if packed is None or autograd:
        with torch.set_grad_enabled(autograd):
            packed = pack_grid_data(grid)
    if train and origins.is_cuda:
        chunk = _Chunk(grid, opt, pool, origins, dirs, sh_mult.detach().contiguous(), near_grid_t,
                       packed, mode, sig_thresh, want_live, want_samples)
        res = _SurfaceFn.apply(*params, bg_rgb, sh_mult, chunk)
        comp = dict(zip(_FN_OUTPUTS, res))
        if mode.cache_size is not None:
            cache = dict(zip(_CACHE_KEYS, res[len(_FN_OUTPUTS):]))
            comp["cache_med"] = cache.pop("cache_med")
            comp["cache"] = cache
        slots = comp
    else:
        if origins.is_cuda:
            sh_mult = sh_mult.detach().contiguous()
        smp = voxel_samples(grid, opt, pool, origins, dirs, sh_mult, near_grid_t, packed)
        comp = composite(grid, opt, pool.offsets, smp, sig_thresh, want_live or want_samples,
                         mode, bg_rgb, want_live_alpha=want_samples)
        slots = dict(comp, t=smp["t"], alpha=smp["alpha"], fake=smp["fake"])
        if want_live:
            slots["pts"] = _slot_points(grid, pool, origins, dirs, smp["t"])
    comp.update(_slot_outputs(slots, want_live, want_samples))
    return comp


def _begin(grid, rays, opt, occupancy):
    """Ray setup shared by the renderers: (origins, dirs, sh_mult, tnear,
    tmax, near_grid_t, ray_ok), the occupancy words and the background
    (``background_color``'s pair, None without one: K13 on the card).
    ``sh_mult`` is evaluated under autograd, so that a learned basis whose
    parameters require grad receives its gradient through the renderer."""
    _check_supported(grid, opt)
    with torch.no_grad():
        origins, dirs, viewdirs, tnear, tmax, near_grid_t, ray_ok, ds = _prep_rays(grid, rays,
                                                                                   opt)
        words = occupancy_words(grid, opt) if occupancy is None else occupancy
    sh_mult = eval_basis(grid, viewdirs)
    bg = background_color(grid, opt, origins, dirs, ds)
    return origins, dirs, sh_mult, tnear, tmax, near_grid_t, ray_ok, words, bg


def _phase_a_bounds(tnear, tmax, ray_ok):
    return (torch.where(ray_ok, tnear, torch.zeros_like(tnear)),
            torch.where(ray_ok, tmax, torch.full_like(tmax, -1.0)))


def _samples(comp: dict, pool: Pool, slot: torch.Tensor, n_slots: int, B: int) -> dict:
    """The JAX walks' ``return_samples``: (B, n_slots * S0) arrays laid out
    as their scans lay out slots, entry e's S0 slots at ``slot[e] * S0``;
    slots of voxels the pool holds no entry for are zero."""
    out = {}
    for k, v in comp["samples"].items():  # (S0, M)
        S0, M = v.shape
        buf = v.new_zeros((B, n_slots, S0))
        buf[pool.ray_id.long(), slot] = v.T
        out[k] = buf.reshape(B, n_slots * S0)
    return out


def volume_render_surface(grid: SparseGrid, rays: Rays, opt: RenderOptions,
                          max_voxels: int | None = None, return_samples: bool = False,
                          cache_size: int | None = None, occupancy: torch.Tensor | None = None,
                          packed: torch.Tensor | None = None) -> dict:
    """The dense DDA walk (surface.py:1092-1143): K11a lists the occupied
    voxels of each ray's ``max_voxels``-step walk, then K3 and K4 run on
    them with the walk's rules (the stop_thresh kill and count per voxel,
    the first max-weight sample's depth). The same keys as the JAX
    package's, with its ``cache`` and cached ``depth_med`` when
    ``cache_size`` is set; ``return_samples`` adds the per-slot ``samples``
    (on the card from K11a's walk steps, K3's slots and K4's live flags and
    truncated alphas). ``occupancy`` and ``packed`` may be shared across
    chunks, as for the packed renderer; on a UDF grid the walk's words are
    ``occupancy_words(grid, opt, candidates=True)``."""
    if max_voxels is None:
        max_voxels = max_voxels_for(grid)
    if occupancy is None and grid.surface_type in UDF_TYPES:
        # the JAX walk hands every walked voxel to its samples: the udf-var
        # count takes the voxels outside the level-set hull too
        with torch.no_grad():
            occupancy = occupancy_words(grid, opt, candidates=True)
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, words, bg = _begin(grid, rays, opt,
                                                                          occupancy)
    with torch.no_grad():
        pool, step = dense_walk(grid, origins, dirs, tnear, tmax, ray_ok, words, max_voxels,
                                want_steps=return_samples)
    mode = _Mode(1, True, cache_size)
    comp = _render_pool(grid, opt, (origins, dirs, sh_mult, ngt), pool, mode, packed, bg=bg,
                        want_samples=return_samples)
    out = _finalize(comp, mode, cache_med_depth=True, bg=bg)
    if return_samples:
        out["samples"] = _samples(comp, pool, step, max_voxels, origins.shape[0])
    return out


def volume_render_surface_compact(grid: SparseGrid, rays: Rays, opt: RenderOptions,
                                  max_intersect_voxels: int = 64,
                                  cache_size: int | None = None, return_samples: bool = False,
                                  unroll: int = 1, voxel_chunk: int = 8,
                                  occupancy: torch.Tensor | None = None,
                                  packed: torch.Tensor | None = None) -> dict:
    """The K-slot renderer (surface.py:2018-2093): the first
    ``max_intersect_voxels`` occupied crossings of each ray (K11b), then K3
    and K4 with the JAX renderer's rules: under stop_thresh it counts every
    sample of a ``voxel_chunk``-voxel pass that starts alive. Equal to the
    dense walk while no ray has more than K occupied crossings;
    ``n_occupied`` is each ray's uncapped count. ``unroll`` is a scheduling
    knob of the JAX scan, accepted for signature parity."""
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, words, bg = _begin(grid, rays, opt,
                                                                          occupancy)
    K = max_intersect_voxels
    with torch.no_grad():
        pool = compact_crossings(grid, origins, dirs, *_phase_a_bounds(tnear, tmax, ray_ok),
                                 words, K)
    V = max(1, min(voxel_chunk, K))
    mode = _Mode(V, True, cache_size)
    comp = _render_pool(grid, opt, (origins, dirs, sh_mult, ngt), pool, mode, packed, bg=bg,
                        want_samples=return_samples)
    out = _finalize(comp, mode, cache_med_depth=True, bg=bg)
    out["n_occupied"] = pool.n_occupied
    if return_samples:  # a slot's position is its pool order
        pos = (torch.arange(pool.close_t.shape[0], device=pool.offsets.device)
               - pool.offsets[pool.ray_id.long()])
        out["samples"] = _samples(comp, pool, pos, -(-K // V) * V, origins.shape[0])
    return out


def volume_render_surface_packed(
    grid: SparseGrid,
    rays: Rays,
    opt: RenderOptions,
    entries_per_ray: float = 8.0,
    cache_size: int | None = None,
    occupancy: torch.Tensor | None = None,
    return_intersections: bool = False,
    depth_sigma_thresh: float | None = None,
    packed: torch.Tensor | None = None,
) -> dict:
    """Render rays through K1-K4; the same keys as the JAX package's
    ``volume_render_surface_packed``, with its first-K ``cache``
    (``cache_size``; ``depth_med`` stays the cache-free median, as JAX's),
    ``depth_sigma_thresh`` and ``intersections`` (whose arrays cover the
    exact pool, M entries by S0 slots, where JAX's cover its padded pool). The pool is
    exact, so ``pool_overflow`` is 0 and ``n_entries_used`` the true count;
    ``entries_per_ray`` is accepted for signature parity. ``occupancy``
    (the words of ``occupancy_words``) and ``packed`` (``pack_grid_data``)
    may be passed in to share them across chunks.

    When a parameter of the grid requires grad, every output the JAX
    package differentiates (rgb, ray_losses, depth, normal, alpha,
    log_transmit, the mode, median and sigma-thresh depths, the cache's
    ts, alphas and weights, the intersections' points, alphas and weights)
    carries gradients to density, surface, SH and fake_sample_std: on the
    card through K5, on the CPU through autograd of the plain path (which
    then packs the rows itself, so that they carry the gradient)."""
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, words, bg = _begin(grid, rays, opt,
                                                                          occupancy)
    with torch.no_grad():
        pool = compact_crossings_packed(grid, origins, dirs,
                                        *_phase_a_bounds(tnear, tmax, ray_ok), words)
    mode = _Mode(cache_size=cache_size)
    comp = _render_pool(grid, opt, (origins, dirs, sh_mult, ngt), pool, mode, packed,
                        depth_sigma_thresh, return_intersections, bg)
    out = _finalize(comp, mode, cache_med_depth=False, bg=bg)
    out["n_occupied"] = pool.n_occupied
    out["n_entries_used"] = pool.close_t.shape[0]
    out["pool_overflow"] = 0
    if depth_sigma_thresh is not None:
        out["depth_sigma_thresh"] = comp["depth_sigma_thresh"]
    if return_intersections:
        out["intersections"] = comp["intersections"]
    return out
