"""Cell-sampled regularizers, the counterpart of the JAX package's
``losses.reg`` (svox2's loss_kernel.cu and its Python twins).

The regularizers of the surface train step run on the card through K6 and,
for the extended surface terms, K12a-K12d, for the background's K12e-K12f
and for the learned texture's TV K12g (``csrc/reg.cu``): one pass
computes the loss and the gradient of the rows, as svox2's kernels did, and
an autograd Function hands back the saved gradient times the loss's
cotangent. On the CPU each has a plain PyTorch
version, differentiated by autograd. Cells are flat lattice ids (int32);
the dense variants are the same kernels over the present rows of
``row_coords_of`` (the empty cells' share in closed form).

The samplers draw a window start from an explicit ``torch.Generator`` (on
the CPU, so that drawing never waits on the card), or take the start they
are given: ``jax.random`` and torch draw different numbers, so a test hands
both packages the same starts. ``row_coords_of`` runs once per topology and
stays plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..core.grid import SparseGrid


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _window_start(generator: torch.Generator, n_starts: int, start: int | None) -> int:
    if start is None:
        return int(torch.randint(0, n_starts, (), generator=generator))
    if not 0 <= int(start) < n_starts:
        raise ValueError(f"window start {start} outside [0, {n_starts})")
    return int(start)


def sample_cells(generator: torch.Generator, grid: SparseGrid, sparse_frac: float,
                 start: int | None = None) -> torch.Tensor:
    """A contiguous window of flat lattice ids covering ``sparse_frac`` of
    the lattice (reg.py:50; svox2.py:6335 contiguous=True, no wraparound)."""
    n = grid.links.numel()
    count = max(1, min(n, int(sparse_frac * n)))
    j0 = _window_start(generator, n - count + 1, start)
    return torch.arange(j0, j0 + count, dtype=torch.int32, device=grid.links.device)


def row_coords_of(grid: SparseGrid) -> torch.Tensor:
    """(capacity, 3) int32 lattice coords of each packed row, for any link
    numbering (reg.py:62). Plain PyTorch, once per topology."""
    X, Y, Z = grid.reso
    flat = grid.links.reshape(-1)
    pos = torch.nonzero(flat >= 0)[:, 0]
    coords = torch.stack([pos // (Z * Y), (pos // Z) % Y, pos % Z], dim=-1).to(torch.int32)
    out = torch.zeros((grid.capacity, 3), dtype=torch.int32, device=flat.device)
    out[flat[pos].long()] = coords
    return out


def present_norm_scale(grid: SparseGrid) -> float:
    """capacity / links.size: a window of present cells stands for a lattice
    window that much longer (reg.py:79)."""
    return grid.capacity / float(grid.links.numel())


def sample_present_cells(generator: torch.Generator, grid: SparseGrid, row_coords: torch.Tensor,
                         sparse_frac: float, start: int | None = None) -> torch.Tensor:
    """K = sparse_frac * capacity consecutive packed rows from a random start,
    as flat lattice ids (reg.py:88)."""
    cap = grid.capacity
    K = max(1, min(cap, int(sparse_frac * cap)))
    j0 = _window_start(generator, cap - K + 1, start)
    c = row_coords[j0:j0 + K]
    X, Y, Z = grid.reso
    return (c[:, 0] * Y + c[:, 1]) * Z + c[:, 2]


# ---------------------------------------------------------------------------
# K6 and K12 through autograd
# ---------------------------------------------------------------------------

class _KernelLoss(torch.autograd.Function):
    """Loss and row gradients from one K6 or K12 launch; the backward scales the
    saved gradients by the loss's cotangent."""

    @staticmethod
    def forward(ctx, run, *params):
        loss, *grads = run()
        ctx.save_for_backward(*grads)
        return loss.reshape(())

    @staticmethod
    def backward(ctx, g):
        return (None, *(g * x for x in ctx.saved_tensors))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cells_to_xyz(cells: torch.Tensor, reso):
    X, Y, Z = reso
    c = cells.long()
    return c // (Y * Z), (c // Z) % Y, c % Z


def _link_at(links: torch.Tensor, x, y, z) -> torch.Tensor:
    """links[x, y, z], -1 out of bounds."""
    X, Y, Z = links.shape
    ok = (x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0) & (z < Z)
    flat = (x.clamp(0, X - 1) * Y + y.clamp(0, Y - 1)) * Z + z.clamp(0, Z - 1)
    return torch.where(ok, links.reshape(-1)[flat], torch.full_like(flat, -1, dtype=links.dtype))


def _fetch(data: torch.Tensor, links: torch.Tensor) -> torch.Tensor:
    """Rows of ``data`` at ``links``, 0 where a link is -1 (fetch_links)."""
    safe = links.clamp(0, data.shape[0] - 1).long()
    return data[safe] * (links >= 0)[..., None].to(data.dtype)


def _tv_plain(grid, data, cells, start_dim, end_dim, weight, scale):
    """Plain version of K6's TV: the sum over the cells, times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    L = grid.links
    l0, lx, ly, lz = _link_at(L, x, y, z), _link_at(L, x + 1, y, z), _link_at(L, x, y + 1, z), \
        _link_at(L, x, y, z + 1)
    v0, vx, vy, vz = (_fetch(data, k)[..., start_dim:end_dim] for k in (l0, lx, ly, lz))
    ok = (l0 >= 0)[..., None]
    zero = torch.zeros_like(v0)
    dx = torch.where(ok & (lx >= 0)[..., None], vx - v0, zero)
    dy = torch.where(ok & (ly >= 0)[..., None], vy - v0, zero)
    dz = torch.where(ok & (lz >= 0)[..., None], vz - v0, zero)
    per_cell = torch.sqrt(1e-5 + dx * dx + dy * dy + dz * dz).sum(-1)
    if weight is not None:
        per_cell = per_cell * torch.sigmoid(_fetch(weight, l0)[..., 0]).detach()
    return torch.sum(per_cell) * scale


def _normal_plain(grid, cells, connectivity_check, ignore_empty, use_l1, scale):
    """Plain version of K6's normal consistency: the sum over the cells,
    times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    n = x.shape[0]
    offs = torch.arange(3, device=x.device)
    ox, oy, oz = torch.meshgrid(offs, offs, offs, indexing="ij")
    links = _link_at(grid.links, x[:, None, None, None] + ox, y[:, None, None, None] + oy,
                     z[:, None, None, None] + oz)  # (n, 3, 3, 3)
    surf = _fetch(grid.surface_data, links)[..., 0]

    def S(i, j, k):
        return surf[:, i, j, k]

    def normal(x, y, z):
        dx = ((S(x + 1, y, z) + S(x + 1, y, z + 1) + S(x + 1, y + 1, z) + S(x + 1, y + 1, z + 1))
              - (S(x, y, z) + S(x, y, z + 1) + S(x, y + 1, z) + S(x, y + 1, z + 1))) / 4
        dy = ((S(x, y + 1, z) + S(x, y + 1, z + 1) + S(x + 1, y + 1, z) + S(x + 1, y + 1, z + 1))
              - (S(x, y, z) + S(x, y, z + 1) + S(x + 1, y, z) + S(x + 1, y, z + 1))) / 4
        dz = ((S(x, y, z + 1) + S(x, y + 1, z + 1) + S(x + 1, y, z + 1) + S(x + 1, y + 1, z + 1))
              - (S(x, y, z) + S(x, y + 1, z) + S(x + 1, y, z) + S(x + 1, y + 1, z))) / 4
        return torch.stack([dx, dy, dz], dim=-1)

    def unit(v):
        # subgradient 0 at v = 0 and no NaN (reg.py:252-256); the squares
        # are summed in K6's order, so that both see the same unit normals
        sq = (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]) + v[..., 2:3] * v[..., 2:3]
        nrm = torch.sqrt(torch.where(sq > 1e-20, sq, torch.full_like(sq, 1e-20)))
        return v / torch.maximum(nrm, nrm.new_full((), 1e-10))

    def exists(i, j, k):
        m = torch.ones(n, dtype=torch.bool, device=x.device)
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    m = m & (links[:, i + di, j + dj, k + dk] >= 0)
        return m

    def empty(i, j, k):
        v = torch.stack([S(i + di, j + dj, k + dk) for di in (0, 1) for dj in (0, 1)
                         for dk in (0, 1)], dim=-1)
        return torch.all(v <= 0, -1) | torch.all(v >= 0, -1)

    N000, N001, N010, N100 = (unit(normal(*o)) for o in ((0, 0, 0), (0, 0, 1), (0, 1, 0),
                                                        (1, 0, 0)))
    diff = (lambda a, b: torch.sum(torch.abs(a - b), -1)) if use_l1 else \
        (lambda a, b: torch.sum((a - b) ** 2, -1))
    dz_, dy_, dx_ = diff(N001, N000), diff(N010, N000), diff(N100, N000)
    m000, m001, m010, m100 = exists(0, 0, 0), exists(0, 0, 1), exists(0, 1, 0), exists(1, 0, 0)
    ones = torch.ones(n, dtype=torch.bool, device=x.device)
    if connectivity_check:
        lv = grid.level_set_data

        def face_con(vals):
            v = torch.stack(vals, -1)
            mn, mx = v.amin(-1, keepdim=True), v.amax(-1, keepdim=True)
            return torch.any((lv[None] >= mn) & (lv[None] <= mx), -1)

        con001 = face_con([S(0, 0, 1), S(0, 1, 1), S(1, 0, 1), S(1, 1, 1)])
        con010 = face_con([S(0, 1, 0), S(0, 1, 1), S(1, 1, 0), S(1, 1, 1)])
        con100 = face_con([S(1, 0, 0), S(1, 0, 1), S(1, 1, 0), S(1, 1, 1)])
    else:
        con001 = con010 = con100 = ones
    if ignore_empty:
        e000, e001, e010, e100 = empty(0, 0, 0), empty(0, 0, 1), empty(0, 1, 0), empty(1, 0, 0)
    else:
        e000 = e001 = e010 = e100 = ~ones
    skip_z = ~m001 | ~m000 | ~con001 | (e000 & e001)
    skip_y = ~m010 | ~m000 | ~con010 | (e000 & e010)
    skip_x = ~m100 | ~m000 | ~con100 | (e000 & e100)
    count = 3.0 - skip_z.to(surf.dtype) - skip_y.to(surf.dtype) - skip_x.to(surf.dtype)
    zero = torch.zeros_like(dz_)
    total = torch.where(skip_x, zero, dx_) + torch.where(skip_y, zero, dy_) \
        + torch.where(skip_z, zero, dz_)
    per_cell = torch.where(count != 0,
                           total / torch.where(count == 0, torch.ones_like(count), count), zero)
    return torch.sum(per_cell) * scale


def _sparsify_plain(grid, cells, scale_alpha, scale_surf, surf_decrease, surf_thresh):
    """Plain version of K6's sparsifier: the mean over the cells."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    l0 = _link_at(grid.links, x, y, z)
    a_raw = _fetch(grid.density_data, l0)[..., 0]
    s = _fetch(grid.surface_data, l0)[..., 0]
    w = torch.sigmoid(-a_raw).detach()
    surf_loss = torch.where(a_raw < surf_thresh, w * s, torch.zeros_like(s))
    if not surf_decrease:
        surf_loss = -surf_loss
    return torch.mean(scale_alpha * F.logsigmoid(a_raw) + scale_surf * surf_loss)


def _interior_cells(grid) -> torch.Tensor:
    """Flat ids of the cells whose 3x3x3 vertex window lies in the lattice."""
    X, Y, Z = grid.reso
    dev = grid.links.device
    xs, ys, zs = (torch.arange(max(r - 2, 0), device=dev) for r in (X, Y, Z))
    return ((xs[:, None, None] * Y + ys[None, :, None]) * Z + zs[None, None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# the regularizers
# ---------------------------------------------------------------------------

def tv_loss(grid: SparseGrid, data: torch.Tensor, cells: torch.Tensor, start_dim: int = 0,
            end_dim: int | None = None) -> torch.Tensor:
    """Total variation over the cells (reg.py:126; tv_grad_sparse,
    loss_kernel.cu:739-809): forward differences to the +x/+y/+z
    neighbours, sqrt over axes per channel, mean over cells."""
    end_dim = data.shape[-1] if end_dim is None else end_dim
    if not data.is_cuda:
        return _tv_plain(grid, data, cells, start_dim, end_dim, None, 1.0 / cells.numel())
    return _KernelLoss.apply(
        lambda: kernels.reg_tv(grid.links, cells, data.detach(), start_dim, end_dim, None,
                               1.0 / cells.numel()), data)


def _surface_tv(grid, cells, alpha_weighted, scale, row_coords=None):
    weight = grid.density_data if alpha_weighted else None
    if not grid.links.is_cuda:
        return _tv_plain(grid, grid.surface_data, cells, 0, 1, weight, scale)
    wdens = None if weight is None else weight.detach()[:, 0].contiguous()
    return _KernelLoss.apply(
        lambda: kernels.reg_tv(grid.links, cells, grid.surface_data.detach(), 0, 1, wdens, scale,
                               row_coords),
        grid.surface_data)


def surface_tv_loss(grid: SparseGrid, cells: torch.Tensor, alpha_weighted: bool = False,
                    ignore_edge: bool = True) -> torch.Tensor:
    """TV of the surface field (reg.py:158; surf_tv_grad_sparse,
    loss_kernel.cu:810-895), optionally weighted by sigmoid(raw alpha)."""
    return _surface_tv(grid, cells, alpha_weighted, 1.0 / cells.numel())


def surface_tv_loss_dense(grid: SparseGrid, row_coords: torch.Tensor,
                          alpha_weighted: bool = False) -> torch.Tensor:
    """``surface_tv_loss`` over every lattice cell, over links.size
    (reg.py:384: the recipe's tv_surface_sparsity = 1). ``row_coords`` is
    ``row_coords_of(grid)``: on the card K6 visits the present rows through
    it and adds the empty cells' sqrt(1e-5) floor in closed form; the plain
    version takes every cell."""
    cells = None if grid.links.is_cuda else torch.arange(grid.links.numel(),
                                                         device=grid.links.device)
    return _surface_tv(grid, cells, alpha_weighted, 1.0 / grid.links.numel(), row_coords)


def _surface_normal(grid, cells, connectivity_check, ignore_empty, use_l1, scale,
                    row_coords=None):
    if not grid.links.is_cuda:
        return _normal_plain(grid, cells, connectivity_check, ignore_empty, use_l1, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_normal(grid.links, cells, grid.surface_data.detach(),
                                   grid.level_set_data, connectivity_check, ignore_empty, use_l1,
                                   scale, row_coords), grid.surface_data)


def surface_normal_loss(grid: SparseGrid, cells: torch.Tensor, connectivity_check: bool = True,
                        ignore_empty: bool = False, use_l1: bool = False) -> torch.Tensor:
    """Normal consistency (reg.py:202; surface_normal_grad_sparse,
    loss_kernel.cu:245-616): each cell's corner-averaged normal against its
    +x/+y/+z neighbours', L1 or squared L2 of the unit normals, with the
    existence, connectivity and empty-cell skips; mean over cells."""
    return _surface_normal(grid, cells, connectivity_check, ignore_empty, use_l1,
                           1.0 / cells.numel())


def surface_normal_loss_dense(grid: SparseGrid, row_coords: torch.Tensor,
                              connectivity_check: bool = True, ignore_empty: bool = False,
                              use_l1: bool = False) -> torch.Tensor:
    """``surface_normal_loss`` over every cell whose 3x3x3 window lies in the
    lattice, over links.size (reg.py:428: norm_surface_sparsity = 1). On the
    card K6 visits the present rows of ``row_coords`` (``row_coords_of``),
    each the base vertex of its cell; the plain version takes every cell."""
    cells = None if grid.links.is_cuda else _interior_cells(grid)
    return _surface_normal(grid, cells, connectivity_check, ignore_empty, use_l1,
                           1.0 / grid.links.numel(), row_coords)


def alpha_surf_sparsify_loss(grid: SparseGrid, cells: torch.Tensor, scale_alpha: float,
                             scale_surf: float, surf_decrease: bool = True,
                             surf_thresh: float = 0.01) -> torch.Tensor:
    """log-sigmoid push on raw alpha plus a surface push weighted by the
    detached sigmoid(-alpha) where alpha is low (reg.py:305;
    alpha_surf_sparsify_grad_sparse, loss_kernel.cu:665-738)."""
    if not grid.links.is_cuda:
        return _sparsify_plain(grid, cells, scale_alpha, scale_surf, surf_decrease, surf_thresh)
    return _KernelLoss.apply(
        lambda: kernels.reg_sparsify(grid.links, cells, grid.density_data.detach(),
                                     grid.surface_data.detach(), scale_alpha, scale_surf,
                                     surf_decrease, surf_thresh, 1.0 / cells.numel()),
        grid.density_data, grid.surface_data)


def _norm_match_plain(grid, cells, scale):
    """Plain version of K12a: the sum over the cells, times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    L = grid.links
    l0, lx, ly, lz = _link_at(L, x, y, z), _link_at(L, x + 1, y, z), _link_at(L, x, y + 1, z), \
        _link_at(L, x, y, z + 1)

    def unit_diffs(data):
        v0 = _fetch(data, l0)[..., 0]
        zero = torch.zeros_like(v0)
        g = torch.stack([torch.where(k >= 0, _fetch(data, k)[..., 0] - v0, zero)
                         for k in (lx, ly, lz)], dim=-1)
        # below the clamp the denominator is a constant (reg.py:587-590)
        sq = (g[..., 0:1] * g[..., 0:1] + g[..., 1:2] * g[..., 1:2]) + g[..., 2:3] * g[..., 2:3]
        nrm = torch.sqrt(torch.where(sq > 1e-16, sq, torch.full_like(sq, 1e-16)))
        return g / torch.maximum(nrm, nrm.new_full((), 1e-8))

    d = unit_diffs(grid.surface_data) - unit_diffs(grid.density_data)
    per_cell = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return torch.sum(torch.where(l0 >= 0, per_cell, torch.zeros_like(per_cell))) * scale


def _viscosity_plain(grid, cells, eta, h, scale):
    """Plain version of K12b: the sum over the cells, times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    L = grid.links
    lk = [_link_at(L, x, y, z), _link_at(L, x + 1, y, z), _link_at(L, x - 1, y, z),
          _link_at(L, x, y + 1, z), _link_at(L, x, y - 1, z), _link_at(L, x, y, z + 1),
          _link_at(L, x, y, z - 1)]
    ok = torch.stack([k >= 0 for k in lk]).all(0)
    s0, spx, smx, spy, smy, spz, smz = (_fetch(grid.surface_data, k)[..., 0] for k in lk)
    h2 = 2 * h
    g2 = ((spx - smx) / h2) ** 2 + ((spy - smy) / h2) ** 2 + ((spz - smz) / h2) ** 2
    gnorm = torch.sqrt(torch.maximum(g2, g2.new_full((), 1e-8)))
    lap = (spx + smx + spy + smy + spz + smz - 6.0 * s0) / (h * h)
    vis = ((gnorm - 1.0) * torch.sign(s0) - eta * lap) ** 2
    return torch.sum(torch.where(ok, vis, torch.zeros_like(vis))) * scale


def _sign_change_plain(grid, cells, scale):
    """Plain version of K12c: the sum over the cells, times ``scale``. A -1
    link reads row cap - 1 (``lnk % cap``, svox2's Python indexing)."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    X, Y, Z = grid.reso
    surf = grid.surface_data[:, 0]
    cap = surf.shape[0]
    flat_links = grid.links.reshape(-1)

    def fetch_wrap(xs, ys, zs):
        flat = (xs.clamp(0, X - 1) * Y + ys.clamp(0, Y - 1)) * Z + zs.clamp(0, Z - 1)
        return surf[torch.remainder(flat_links[flat].long(), cap)]

    s0 = fetch_wrap(x, y, z)
    total = torch.zeros_like(s0)
    count = torch.zeros_like(s0)
    for (xs, ys, zs), inb, r in (((x + 1, y, z), x + 1 < X, X), ((x, y + 1, z), y + 1 < Y, Y),
                                 ((x, y, z + 1), z + 1 < Z, Z)):
        sn = torch.where(inb, fetch_wrap(xs, ys, zs), s0)
        hit = (s0 * sn < 0.0) & inb
        total = total + torch.where(hit, (s0 + sn) * (r / 256.0), torch.zeros_like(s0))
        count = count + hit.to(s0.dtype)
    per_cell = torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(s0))
    return torch.sum(per_cell) * scale


def _eikonal_plain(grid, cells, target, scale):
    """Plain version of K12d: the sum over the cells, times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    offs = torch.arange(2, device=x.device)
    ox, oy, oz = torch.meshgrid(offs, offs, offs, indexing="ij")
    links = _link_at(grid.links, x[:, None, None, None] + ox, y[:, None, None, None] + oy,
                     z[:, None, None, None] + oz)  # (n, 2, 2, 2)
    surf = _fetch(grid.surface_data, links)[..., 0]
    ok = torch.all(links.reshape(links.shape[0], -1) >= 0, -1)
    dx = torch.mean(surf[:, 1] - surf[:, 0], dim=(-1, -2))
    dy = torch.mean(surf[:, :, 1] - surf[:, :, 0], dim=(-1, -2))
    dz = torch.mean(surf[:, :, :, 1] - surf[:, :, :, 0], dim=(-1, -2))
    gnorm = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    per_cell = (gnorm - target) ** 2
    return torch.sum(torch.where(ok, per_cell, torch.zeros_like(per_cell))) * scale


def surface_norm_match_loss(grid: SparseGrid, cells: torch.Tensor) -> torch.Tensor:
    """K12a: the unit forward-difference gradient of the surface field
    against that of raw alpha, squared, over cells.shape[0] (reg.py:569;
    svox2.py:5474-5521). An absent neighbour gives a zero difference;
    empty centres count in the mean with 0."""
    scale = 1.0 / cells.numel()
    if not grid.links.is_cuda:
        return _norm_match_plain(grid, cells, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_norm_match(grid.links, cells, grid.density_data.detach(),
                                       grid.surface_data.detach(), scale),
        grid.density_data, grid.surface_data)


def surface_viscosity_loss(grid: SparseGrid, cells: torch.Tensor, eta: float = 1e-2,
                           h=1.0) -> torch.Tensor:
    """K12b: ((|central difference| - 1) sign(s0) - eta laplacian)^2 over
    the cells whose 6-neighbourhood is present, over cells.shape[0]
    (reg.py:599; svox2.py:5525-5594). ``h`` is the grid spacing: a float or
    a 0-d tensor on the grid's device (the step's, read there without a
    host sync)."""
    scale = 1.0 / cells.numel()
    if not grid.links.is_cuda:
        return _viscosity_plain(grid, cells, eta, h, scale)
    h = torch.as_tensor(h, dtype=torch.float32, device=grid.links.device).reshape(1)
    return _KernelLoss.apply(
        lambda: kernels.reg_viscosity(grid.links, cells, grid.surface_data.detach(), h, eta,
                                      scale), grid.surface_data)


def surface_sign_change_loss(grid: SparseGrid, cells: torch.Tensor) -> torch.Tensor:
    """K12c: over the +x/+y/+z neighbours whose surface value changes sign
    against the cell's, (s0 + sn) reso/256, averaged over those axes; mean
    over the cells (reg.py:630; svox2.py:5597-5651). A -1 link reads and
    trains row cap - 1, as svox2's twin does; an out-of-range neighbour
    counts as no sign change."""
    scale = 1.0 / cells.numel()
    if not grid.links.is_cuda:
        return _sign_change_plain(grid, cells, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_sign_change(grid.links, cells, grid.surface_data.detach(), scale),
        grid.surface_data)


def surface_eikonal_loss(grid: SparseGrid, cells: torch.Tensor,
                         target: float = 1.0) -> torch.Tensor:
    """K12d: (|g| - target)^2 over the cells whose 8 corners are present,
    g the mean of the 4 edge differences per axis; mean over the cells
    (reg.py:791; svox2.py:5352)."""
    scale = 1.0 / cells.numel()
    if not grid.links.is_cuda:
        return _eikonal_plain(grid, cells, target, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_eikonal(grid.links, cells, grid.surface_data.detach(), target,
                                    scale), grid.surface_data)


def l2_color_loss(grid: SparseGrid) -> torch.Tensor:
    """0.5 * mean row-sum of sh^2 (reg.py:666; inplace_l2_color_grad)."""
    return 0.5 * torch.sum(grid.sh_data ** 2) / grid.sh_data.shape[0]


# ---------------------------------------------------------------------------
# K12e, K12f: the SH colours' lumisphere TV and the background's TV
# ---------------------------------------------------------------------------

def _lumisphere_plain(grid, cells, sh_mult, sh_mult_u, dir_factor, scale):
    """Plain version of K12e: the sum over the cells, times ``scale``."""
    x, y, z = _cells_to_xyz(cells, grid.reso)
    L = grid.links
    bd = grid.basis_dim
    l0 = _link_at(L, x, y, z)

    def color(lnk, mult):
        return torch.sum(_fetch(grid.sh_data, lnk).reshape(-1, 3, bd) * mult, -1)  # (n, 3)

    c0 = color(l0, sh_mult)
    loss = torch.zeros(cells.shape[0], dtype=grid.sh_data.dtype, device=L.device)
    for ln in (_link_at(L, x + 1, y, z), _link_at(L, x, y + 1, z), _link_at(L, x, y, z + 1)):
        cn = color(ln, sh_mult)
        ok = ((l0 >= 0) & (ln >= 0)).to(c0.dtype)
        loss = loss + ok * torch.sqrt(1e-5 + torch.sum((cn - c0) ** 2, -1))
    if dir_factor > 0.0:
        c0_u = color(l0, sh_mult_u)
        ok0 = (l0 >= 0).to(c0.dtype)
        loss = loss + dir_factor * ok0 * torch.sqrt(1e-5 + torch.sum((c0_u - c0) ** 2, -1))
    return torch.sum(loss) * scale


def lumisphere_directions(generator: torch.Generator, dir_perturb_radians: float = 0.05):
    """A random unit direction and its twin turned by ``dir_perturb_radians``
    about a random axis (Rodrigues' formula), both (3,) float64 on the CPU,
    drawn from ``generator`` as the JAX package draws them from its key
    (reg.py:748-762)."""
    d = torch.randn(3, generator=generator, dtype=torch.float64)
    d = d / torch.linalg.norm(d)
    axis = torch.randn(3, generator=generator, dtype=torch.float64)
    axis = axis / torch.linalg.norm(axis) * dir_perturb_radians
    th = torch.linalg.norm(axis)
    k = axis / torch.clamp(th, min=1e-12)
    d_p = (d * torch.cos(th) + torch.linalg.cross(k, d) * torch.sin(th)
           + k * torch.dot(k, d) * (1 - torch.cos(th)))
    return d, d_p


def lumisphere_tv_at(grid: SparseGrid, cells: torch.Tensor, d, d_p,
                     dir_factor: float = 1.0) -> torch.Tensor:
    """K12e at the directions ``d`` and its perturbed twin ``d_p`` ((3,)
    each): the SH colour of each cell along ``d`` against its +x/+y/+z
    neighbours', plus ``dir_factor`` times the colour along ``d`` against
    that along ``d_p``, each sqrt(1e-5 + |difference|^2); mean over the
    cells (reg.py:734; lumisphere_tv_grad_sparse, svox2.py:5822-5895). A
    neighbour term needs both links present, the angular term the cell's."""
    from ..core.sh import eval_sh_bases

    dt, dev = grid.sh_data.dtype, grid.links.device
    mult = eval_sh_bases(grid.basis_dim, torch.stack([torch.as_tensor(d), torch.as_tensor(d_p)])
                         .to(dtype=dt, device=dev))  # (2, bd)
    scale = 1.0 / cells.numel()
    if not grid.links.is_cuda:
        return _lumisphere_plain(grid, cells, mult[0], mult[1], dir_factor, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_lumisphere(grid.links, cells, grid.sh_data.detach(),
                                       mult.contiguous(), dir_factor, scale),
        grid.sh_data)


def lumisphere_tv_loss(grid: SparseGrid, cells: torch.Tensor, generator: torch.Generator,
                       dir_factor: float = 1.0, dir_perturb_radians: float = 0.05):
    """K12e along a direction drawn from ``generator`` (reg.py:734):
    ``lumisphere_tv_at`` of ``lumisphere_directions``."""
    d, d_p = lumisphere_directions(generator, dir_perturb_radians)
    return lumisphere_tv_at(grid, cells, d, d_p, dir_factor)


def sample_background_cells(generator: torch.Generator, grid: SparseGrid,
                            sparse_frac: float) -> torch.Tensor:
    """max(1, int(sparse_frac * n)) flat (u, v, layer) cell ids of the
    background's n = links.size * nlayers cells, drawn with replacement, as
    the JAX step draws them (steps.py:181-184)."""
    n = grid.background_links.numel() * grid.background_nlayers
    count = max(1, int(sparse_frac * n))
    return torch.randint(0, n, (count,), generator=generator, dtype=torch.int64).to(
        device=grid.background_links.device, dtype=torch.int32)


def _background_tv_plain(grid, cells_bg, scaling, scaling_density, scale):
    """Plain version of K12f: the sum over the cells, times ``scale``."""
    links = grid.background_links  # (2R, R)
    data = grid.background_data  # (n, nlayers, 4)
    W, H = links.shape
    nlayers = data.shape[1]
    c = cells_bg.long()
    layer = c % nlayers
    uv = c // nlayers
    v = uv % H
    u = (uv // H) % W
    flat = links.reshape(-1)
    l0 = flat[u * H + v]
    lu = flat[((u + 1) % W) * H + v]
    lv_ = flat[u * H + torch.clamp(v + 1, max=H - 1)]

    def fetch(lnk, lay):
        safe = torch.clamp(lnk, 0, data.shape[0] - 1).long()
        return data[safe, lay] * (lnk >= 0)[:, None].to(data.dtype)

    v0 = fetch(l0, layer)
    zero = torch.zeros_like(v0)
    du = torch.where((lu >= 0)[:, None], fetch(lu, layer) - v0, zero)
    dv = torch.where((lv_ >= 0)[:, None], fetch(lv_, layer) - v0, zero)
    dl = fetch(l0, torch.clamp(layer + 1, max=nlayers - 1)) - v0
    tv = torch.sqrt(1e-5 + du ** 2 + dv ** 2 + dl ** 2)  # (n, 4)
    per_cell = scaling * tv[:, :3].sum(-1) + scaling_density * tv[:, 3]
    return torch.sum(per_cell * (l0 >= 0).to(tv.dtype)) * scale


def background_tv_loss(grid: SparseGrid, cells_bg: torch.Tensor, scaling: float,
                       scaling_density: float | None = None) -> torch.Tensor:
    """K12f: the TV of the MSI background at the flat (u, v, layer) cells
    ``cells_bg`` (int32), each channel sqrt(1e-5 + du^2 + dv^2 + dl^2) to
    the +u (wrapping), +v and +layer (both clamped) neighbours, an absent
    neighbour's difference 0; the colour channels scaled by ``scaling``,
    density by ``scaling_density`` (default ``scaling``); mean over the
    cells, a cell with link -1 counting 0 (reg.py:673; msi_tv_grad_sparse,
    svox2.py:5930-5957). 0 without a background."""
    if grid.background_data is None:
        return 0.0
    if scaling_density is None:
        scaling_density = scaling
    scale = 1.0 / cells_bg.numel()
    if not grid.background_links.is_cuda:
        return _background_tv_plain(grid, cells_bg, scaling, scaling_density, scale)
    return _KernelLoss.apply(
        lambda: kernels.reg_background_tv(grid.background_links, cells_bg,
                                          grid.background_data.detach(), scaling,
                                          scaling_density, scale),
        grid.background_data)


def _basis_tv_plain(basis_data: torch.Tensor) -> torch.Tensor:
    bd = basis_data
    return torch.mean(torch.sqrt(
        1e-5
        + (bd[:-1, :-1, 1:] - bd[:-1, :-1, :-1]) ** 2
        + (bd[:-1, 1:, :-1] - bd[:-1, :-1, :-1]) ** 2
        + (bd[1:, :-1, :-1] - bd[:-1, :-1, :-1]) ** 2
    ).sum(-1))


def basis_tv_loss(grid: SparseGrid):
    """K12g: the TV of the learned 3D-texture basis (reg.py:717;
    inplace_tv_basis_grad, svox2.py:5959-5970), dense: the mean over the
    (R-1)^3 cells of the sum over channels of sqrt(1e-5 + dz^2 + dy^2 +
    dx^2), the forward differences of each channel. 0 without a texture."""
    if grid.basis_data is None:
        return 0.0
    bd = grid.basis_data
    if not bd.is_cuda:
        return _basis_tv_plain(bd)
    R = bd.shape[0]
    return _KernelLoss.apply(lambda: kernels.reg_basis_tv(bd.detach(), 1.0 / (R - 1) ** 3), bd)
