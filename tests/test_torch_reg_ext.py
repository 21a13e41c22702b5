"""The extended surface regularizers (K12a-K12d) against the JAX package's
``losses.reg``, value and gradient of both fields, in float64 on the CPU
(the plain versions), and the kernels against the plain versions on the
card (marked ``cuda``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_tpu.losses import reg as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as T
from test_torch_util import jax_grid, jax_to_np

FIELDS = ("density_data", "surface_data")
ETA, H = 0.05, 0.7
# name -> (JAX loss, port loss), each of (grid, cells)
LOSSES = {
    "norm_match": (J.surface_norm_match_loss, T.surface_norm_match_loss),
    "viscosity": (lambda g, c: J.surface_viscosity_loss(g, c, eta=ETA, h=H),
                  lambda g, c: T.surface_viscosity_loss(g, c, eta=ETA, h=H)),
    "sign_change": (J.surface_sign_change_loss, T.surface_sign_change_loss),
    "eikonal": (J.surface_eikonal_loss, T.surface_eikonal_loss),
}


def ext_grid(reso=16, seed=0) -> dict:
    """make_gt_grid(reso) with 15% of the links set to -1 (their rows stay,
    so that row cap - 1 is a present corner cell), the surface perturbed and
    raw alpha noisy on half of the rows (constant on the rest, so that some
    alpha differences are 0 and take the safe normalisation's clamp)."""
    a = jax_to_np(jax_make_gt_grid(reso, basis_dim=4))
    a = {k: (np.asarray(v, np.float64) if isinstance(v, np.ndarray) and v.dtype == np.float32
             else v) for k, v in a.items()}
    rng = np.random.default_rng(seed)
    links = a["links"].reshape(-1).copy()
    drop = rng.random(links.size) < 0.15
    drop[-1] = False  # row cap - 1 stays linked
    links[drop] = -1
    a["links"] = links.reshape(a["links"].shape)
    cap = a["density_data"].shape[0]
    a["surface_data"] = a["surface_data"] + rng.standard_normal((cap, 1)) * 0.3
    a["density_data"] = a["density_data"] + rng.standard_normal((cap, 1)) * (
        rng.random((cap, 1)) < 0.5)
    return a


def _windows(g: SparseGrid):
    """Every lattice cell (border cells x + 1 = X, empty centres, sign
    changes against empty neighbours, which read row cap - 1) and a
    present-cell window (the main path's sampler)."""
    rc = T.row_coords_of(g)
    every = torch.arange(g.links.numel(), dtype=torch.int32)
    return every, T.sample_present_cells(None, g, rc, 0.3, start=11)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_extended_losses_match_jax(name):
    """Value and gradient of density and surface to rtol 1e-10 / atol
    1e-12, on both windows; viscosity at h = H, and again at the step's
    h = 2 mean(radius) / mean(gsz) with radius 1.3."""
    a = ext_grid()
    j_fn, t_fn = LOSSES[name]
    cases = [(a, j_fn, t_fn)]
    if name == "viscosity":
        a2 = dict(a, radius=np.full(3, 1.3))
        h = 2.0 * 1.3 / 16.0
        cases.append((a2, lambda g, c: J.surface_viscosity_loss(g, c, eta=ETA, h=h),
                      lambda g, c: T.surface_viscosity_loss(
                          g, c, eta=ETA, h=2.0 * torch.mean(g.radius) / torch.mean(g.gsz))))
    for arrs, jf, tf in cases:
        gj, gt = jax_grid(arrs), SparseGrid.from_numpy(arrs, device="cpu")
        for cells in _windows(gt):
            cj = jnp.asarray(cells.numpy())

            def jloss(*fields):
                return jf(gj.replace(**dict(zip(FIELDS, fields))), cj)

            ref_v, ref_g = jax.value_and_grad(jloss, argnums=(0, 1))(
                *(jnp.asarray(arrs[f]) for f in FIELDS))
            params = [getattr(gt, f).requires_grad_(True) for f in FIELDS]
            v = tf(gt, cells)
            got = torch.autograd.grad(v, params, allow_unused=True)
            for p in params:
                p.requires_grad_(False)
            np.testing.assert_allclose(float(v.detach()), float(ref_v), rtol=1e-10, atol=1e-12)
            assert float(ref_v) != 0.0
            for f, gk, r in zip(FIELDS, got, ref_g):
                gk = np.zeros_like(np.asarray(r)) if gk is None else gk.numpy()
                np.testing.assert_allclose(gk, np.asarray(r), rtol=1e-10, atol=1e-12,
                                           err_msg=f"{name} {f}")
            touched = np.abs(np.asarray(ref_g[1])).max(-1) > 0
            assert touched.any()
            if name == "sign_change" and cells.numel() == gt.links.numel():
                # empty cells and neighbours read, and train, row cap - 1
                assert touched[-1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_extended_kernels_match_plain_versions(cuda, name):
    """K12a-K12d against their plain versions in float32 on the card: the
    loss to rtol 1e-5, each gradient to 1e-5 of its norm."""
    from alphasurf_torch import kernels

    a = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
             else v) for k, v in ext_grid().items()}
    g = SparseGrid.from_numpy(a, device=cuda)
    t_fn = LOSSES[name][1]
    for cells in _windows(g):
        cells = cells.to(cuda)
        kernels.reset_launches()
        params = [getattr(g, f).requires_grad_(True) for f in FIELDS]
        vk = t_fn(g, cells)
        gk = torch.autograd.grad(vk, params, allow_unused=True)
        assert kernels.LAUNCHES[f"reg_{name}"] == 1
        cpu = SparseGrid.from_numpy(a, device="cpu")
        pp = [getattr(cpu, f).requires_grad_(True) for f in FIELDS]
        vp = t_fn(cpu, cells.cpu())
        gp = torch.autograd.grad(vp, pp, allow_unused=True)
        for p in params:
            p.requires_grad_(False)
        np.testing.assert_allclose(float(vk), float(vp), rtol=1e-5)
        for x, y in zip(gk, gp):
            y = torch.zeros_like(pp[0]) if y is None else y
            x = torch.zeros_like(y) if x is None else x.cpu()
            assert float((x - y).norm()) <= 1e-5 * max(float(y.norm()), 1e-30)
