"""K6's TV and normal kernels on the card against their plain versions, in
both modes: every cell (the present rows through the row coordinates, the
empty cells' floor in closed form) and windows of cells (a thread a cell,
or a warp a cell with float4 row atomics for many channels). The grids
cross warp and block edges (capacities and windows of no round size), the
lattice's borders (a grid with every vertex present), hold rows no link
names (the capacity above the present links), 27 and 40 channels and a
density table shorter than the rows (UDF_ALPHA's). Marked ``cuda``: they
need a card and skip without one. The file imports nothing of JAX, so it
also runs on a card machine without JAX, where the tests' conftest cannot
load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_reg.py
"""
import pytest
import torch

from alphasurf_torch import kernels
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as R
from reg_grids import shell_arrays

# chip_smoke.py's REG_LOSS_RTOL and REG_REL: the same per-cell float32
# arithmetic in the same order; the loss a float32 sum over cells in
# another order (and the empty cells' share in float64), each row's
# gradient a sum of at most 20 contributions in another order
LOSS_RTOL, GRAD_REL = 1e-5, 1e-5

GRIDS = {
    "shell": dict(reso=(21, 21, 21), prune=0.2),
    "non_cubic_orphans": dict(reso=(18, 11, 23), prune=0.3, orphans=37, unlink=29, link000=True),
    "dense_borders": dict(reso=(13, 17, 11), prune=0.0, dense=True),
    "wide_channels": dict(reso=(15, 12, 14), prune=0.25, orphans=5, unlink=6, channels=40),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _grid(name, device):
    a = shell_arrays(seed=7, dtype="float32", **GRIDS[name])
    return SparseGrid.from_numpy(a, device=device)


def _hold(run_kernel, run_plain, param):
    """Kernel (loss, grad) against the plain loss and its autograd gradient
    in ``param``."""
    lk, gk = run_kernel()
    torch.cuda.synchronize()
    param.requires_grad_(True)
    try:
        lp = run_plain()
        (gp,) = torch.autograd.grad(lp, [param])
    finally:
        param.requires_grad_(False)
    lp = float(lp.detach())
    assert abs(float(lk) - lp) <= LOSS_RTOL * abs(lp), (float(lk), lp)
    rel = float((gk.double() - gp.double()).norm() / gp.double().norm().clamp(min=1e-30))
    assert rel <= GRAD_REL, rel
    assert gp.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("weighted", [False, True])
def test_every_cell_tv_matches_plain_version(cuda, name, weighted):
    g = _grid(name, cuda)
    rc = R.row_coords_of(g)
    N = g.links.numel()
    wd = g.density_data[:, 0].contiguous() if weighted else None
    before = kernels.LAUNCHES["reg_tv_every"]
    _hold(lambda: kernels.reg_tv(g.links, None, g.surface_data, 0, 1, wd, 1.0 / N, row_coords=rc),
          lambda: R._tv_plain(g, g.surface_data, torch.arange(N, device=cuda), 0, 1,
                              g.density_data if weighted else None, 1.0 / N), g.surface_data)
    assert kernels.LAUNCHES["reg_tv_every"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("con_check,ignore_empty,use_l1",
                         [(False, False, True), (False, False, False), (True, True, True),
                          (True, False, False)])
def test_every_cell_normal_matches_plain_version(cuda, name, con_check, ignore_empty, use_l1):
    g = _grid(name, cuda)
    rc = R.row_coords_of(g)
    N = g.links.numel()
    before = kernels.LAUNCHES["reg_normal_every"]
    _hold(lambda: kernels.reg_normal(g.links, None, g.surface_data, g.level_set_data, con_check,
                                     ignore_empty, use_l1, 1.0 / N, row_coords=rc),
          lambda: R._normal_plain(g, R._interior_cells(g), con_check, ignore_empty, use_l1,
                                  1.0 / N), g.surface_data)
    assert kernels.LAUNCHES["reg_normal_every"] == before + 1


def _windows(g):
    """A window of present rows from an odd start and a lattice window that
    holds empty cells, neither a multiple of a warp or a block."""
    rc = R.row_coords_of(g)
    return {"present": R.sample_present_cells(None, g, rc, 0.37, start=13),
            "lattice": R.sample_cells(None, g, 0.41, start=29)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("channels", ["all", "inner", "narrow"])
@pytest.mark.parametrize("weighted", [False, True])
def test_window_tv_matches_plain_version(cuda, name, channels, weighted):
    g = _grid(name, cuda)
    C = g.sh_data.shape[1]
    c0, c1 = {"all": (0, C), "inner": (2, C - 3), "narrow": (1, 3)}[channels]
    wd = g.density_data[:, 0].contiguous() if weighted else None
    for cells in _windows(g).values():
        n = cells.numel()
        _hold(lambda: kernels.reg_tv(g.links, cells, g.sh_data, c0, c1, wd, 1.0 / n),
              lambda: R._tv_plain(g, g.sh_data, cells, c0, c1,
                                  g.density_data if weighted else None, 1.0 / n), g.sh_data)
        _hold(lambda: kernels.reg_tv(g.links, cells, g.density_data, 0, 1, wd, 1.0 / n),
              lambda: R._tv_plain(g, g.density_data, cells, 0, 1,
                                  g.density_data if weighted else None, 1.0 / n),
              g.density_data)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 27])
def test_window_tv_on_a_short_table_matches_plain_version(cuda, channels):
    """A table shorter than the rows (UDF_ALPHA's density, one row a level
    set): every link past it reads and trains its last row, as weight and
    as data."""
    g = _grid("non_cubic_orphans", cuda)
    table = g.sh_data[:40, :channels].contiguous()
    wd = g.density_data[:20, 0].contiguous()
    weight = g.density_data[:20]
    rc = R.row_coords_of(g)
    # windows from the first rows, whose links lie inside the table
    for cells in (R.sample_present_cells(None, g, rc, 0.37, start=0),
                  R.sample_cells(None, g, 0.41, start=0)):
        n = cells.numel()
        _hold(lambda: kernels.reg_tv(g.links, cells, table, 0, channels, wd, 1.0 / n),
              lambda: R._tv_plain(g, table, cells, 0, channels, weight, 1.0 / n), table)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("con_check,ignore_empty,use_l1", [(False, False, True),
                                                           (True, True, False)])
def test_window_normal_matches_plain_version(cuda, name, con_check, ignore_empty, use_l1):
    g = _grid(name, cuda)
    for cells in _windows(g).values():
        n = cells.numel()
        _hold(lambda: kernels.reg_normal(g.links, cells, g.surface_data, g.level_set_data,
                                         con_check, ignore_empty, use_l1, 1.0 / n),
              lambda: R._normal_plain(g, cells, con_check, ignore_empty, use_l1, 1.0 / n),
              g.surface_data)


@pytest.mark.cuda
def test_dense_losses_on_the_card_match_the_cpu(cuda):
    """The dense losses through their entry points, with autograd: the card
    (K6 on the present rows) against the CPU's plain versions."""
    a = shell_arrays(seed=3, dtype="float32", **GRIDS["non_cubic_orphans"])
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = SparseGrid.from_numpy(a, device=dev)
        rc = R.row_coords_of(g)
        g.surface_data.requires_grad_(True)
        loss = (R.surface_tv_loss_dense(g, rc, alpha_weighted=True)
                + R.surface_normal_loss_dense(g, rc, False, False, use_l1=True)
                + 0.5 * R.surface_normal_loss_dense(g, rc, True, True, use_l1=False))
        (grad,) = torch.autograd.grad(loss, [g.surface_data])
        out.append((float(loss.detach()), grad.cpu()))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= LOSS_RTOL * abs(lp)
    assert float((gk - gp).double().norm() / gp.double().norm()) <= GRAD_REL
