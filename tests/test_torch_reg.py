"""The port's regularizers and samplers against the JAX package's
``losses.reg``, value and gradient, in float64 on the CPU (the plain
versions; chip_smoke.py holds K6 against them on the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.losses import reg as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as T
from test_torch_util import jax_grid, np_grid

FIELDS = ("density_data", "sh_data", "surface_data")


def _grids(seed=3):
    a = np_grid(12, seed=seed, prune=0.1, n_lv=2)
    return a, jax_grid(a), SparseGrid.from_numpy(a, device="cpu")


def _compare(j_fn, t_fn, a, gj, gt, fields=FIELDS):
    """Value and gradient in each of ``fields`` of j_fn(grid) and t_fn(grid)."""
    def jf(*arrs):
        return j_fn(gj.replace(**dict(zip(fields, arrs))))

    ref_v, ref_g = jax.value_and_grad(jf, argnums=tuple(range(len(fields))))(
        *(jnp.asarray(a[f]) for f in fields))
    params = [getattr(gt, f).requires_grad_(True) for f in fields]
    v = t_fn(gt)
    got = torch.autograd.grad(v, params, allow_unused=True)
    for p in params:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(v.detach()), float(ref_v), rtol=1e-12, atol=1e-15)
    for f, g, r in zip(fields, got, ref_g):
        g = np.zeros_like(np.asarray(r)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-10, atol=1e-14, err_msg=f)
    return ref_v, ref_g


def _windows(gt, gj):
    """A present-cell window (the main path's sampler) and a lattice window
    that holds empty cells, as flat ids for both packages."""
    rc = T.row_coords_of(gt)
    present = T.sample_present_cells(None, gt, rc, 0.4, start=7)
    lattice = T.sample_cells(None, gt, 0.3, start=300)
    return [(c, jnp.asarray(c.numpy())) for c in (present, lattice)]


def test_samplers_match_jax():
    a, gj, gt = _grids()
    rc_j, rc_t = J.row_coords_of(gj), T.row_coords_of(gt)
    np.testing.assert_array_equal(rc_t.numpy(), np.asarray(rc_j))
    assert T.present_norm_scale(gt) == J.present_norm_scale(gj)
    key = jax.random.PRNGKey(3)
    cap = gt.capacity
    K = int(0.05 * cap)
    j0 = int(jax.random.randint(key, (), 0, cap - K + 1, dtype=jnp.int32))
    np.testing.assert_array_equal(T.sample_present_cells(None, gt, rc_t, 0.05, start=j0).numpy(),
                                  np.asarray(J.sample_present_cells(key, gj, rc_j, 0.05)))
    n = gt.links.numel()
    s0 = int(jax.random.randint(key, (), 0, n - int(0.05 * n) + 1, dtype=jnp.int32))
    np.testing.assert_array_equal(T.sample_cells(None, gt, 0.05, start=s0).numpy(),
                                  np.asarray(J.sample_cells(key, gj, 0.05)))
    gen = torch.Generator().manual_seed(0)
    cells = T.sample_present_cells(gen, gt, rc_t, 0.05)
    assert cells.dtype == torch.int32 and cells.numel() == K
    with pytest.raises(ValueError):
        T.sample_present_cells(None, gt, rc_t, 0.05, start=cap)


@pytest.mark.parametrize("channels", [(None, 0, None), (None, 2, 11)])
def test_tv_loss_matches_jax(channels):
    a, gj, gt = _grids()
    _, s, e = channels
    for cells_t, cells_j in _windows(gt, gj):
        for field in ("density_data", "sh_data"):
            _compare(lambda g: J.tv_loss(g, getattr(g, field), cells_j, s, e),
                     lambda g: T.tv_loss(g, getattr(g, field), cells_t, s, e), a, gj, gt, (field,))


@pytest.mark.parametrize("alpha_weighted", [False, True])
def test_surface_tv_matches_jax(alpha_weighted):
    a, gj, gt = _grids()
    for cells_t, cells_j in _windows(gt, gj):
        _compare(lambda g: J.surface_tv_loss(g, cells_j, alpha_weighted),
                 lambda g: T.surface_tv_loss(g, cells_t, alpha_weighted), a, gj, gt)
    rc = J.row_coords_of(gj)
    _compare(lambda g: J.surface_tv_loss_dense(g, rc, alpha_weighted),
             lambda g: T.surface_tv_loss_dense(g, T.row_coords_of(g), alpha_weighted), a, gj,
             gt)


@pytest.mark.parametrize("use_l1", [True, False])
@pytest.mark.parametrize("con_check,ignore_empty", [(False, False), (True, True)])
def test_surface_normal_matches_jax(use_l1, con_check, ignore_empty):
    a, gj, gt = _grids()
    for cells_t, cells_j in _windows(gt, gj):
        v, g = _compare(lambda g: J.surface_normal_loss(g, cells_j, con_check, ignore_empty, use_l1),
                        lambda g: T.surface_normal_loss(g, cells_t, con_check, ignore_empty, use_l1),
                        a, gj, gt, ("surface_data",))
        assert float(v) > 0 and np.abs(np.asarray(g[0])).max() > 0
    rc = J.row_coords_of(gj)
    _compare(lambda g: J.surface_normal_loss_dense(g, rc, con_check, ignore_empty, use_l1),
             lambda g: T.surface_normal_loss_dense(g, T.row_coords_of(g), con_check, ignore_empty,
                                                   use_l1),
             a, gj, gt, ("surface_data",))


@pytest.mark.parametrize("decrease", [True, False])
def test_sparsify_and_l2_color_match_jax(decrease):
    a, gj, gt = _grids()
    for cells_t, cells_j in _windows(gt, gj):
        _compare(lambda g: J.alpha_surf_sparsify_loss(g, cells_j, 0.7, 1.3, decrease, 0.5),
                 lambda g: T.alpha_surf_sparsify_loss(g, cells_t, 0.7, 1.3, decrease, 0.5),
                 a, gj, gt)
    _compare(J.l2_color_loss, T.l2_color_loss, a, gj, gt)
