"""The compat marches "nvol" and "svox1" (K14's path) against the JAX
package's ``render.compat`` on the CPU: forward and the gradients into
density, SH and a learned texture basis in float64, a float32 render, the
backend dispatch, and the svox1 (N3Tree) export against JAX's file."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu import defs
from alphasurf_tpu.geometry.svox1 import to_svox1_npz as jax_to_svox1_npz
from alphasurf_tpu.render import compat as JCm
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.geometry.svox1 import to_svox1_npz
from alphasurf_torch.render import compat as TCm
from test_torch_basis import jax_basis_grid, np_texture
from test_torch_util import jax_grid, jax_to_np, np_grid, np_rays, t64

MODES = ("nvol", "svox1")
# a threshold that leaves some steps unused, and one that uses them all
OPTS = {"thresh": dict(step_size=0.5, sigma_thresh=0.5, background_brightness=0.7),
        "all": dict(step_size=0.35, sigma_thresh=-1e9, background_brightness=1.0)}
KEYS = {"nvol": ("rgb", "alpha", "depth", "log_transmit"),
        "svox1": ("rgb", "log_transmit", "depth")}


@functools.lru_cache(maxsize=None)
def _arrays():
    """A 10^3 grid with half the raw alphas of np_grid as densities (negative
    in places: relu's zero side; nvol saturates on about half the rays) and
    a texture basis."""
    a = np_grid(10, seed=3, prune=0.1, basis_dim=4)
    a["density_data"] = a["density_data"] * 0.5
    a["basis_type"], a["basis_data"] = defs.BASIS_TYPE_3D_TEXTURE, np_texture(R=6)
    return a


def _rays():
    """48 rays toward the grid, and 4 that miss it or run along an axis."""
    o, d = np_rays(48, seed=6)
    o = np.concatenate([o, [[3.0, 3.0, 3.0], [0.0, 0.0, -2.5], [0.3, -0.2, -2.5], [0.0, 0.1, 0.0]]])
    d = np.concatenate([d, [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.6, 0.0, 0.8]]])
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("opt_name", list(OPTS))
@pytest.mark.parametrize("mode", MODES)
def test_compat_forward_and_gradients_match_jax(mode, opt_name):
    """Every output to rtol 1e-10, and the gradients of a weighted sum of
    rgb with respect to density, SH and the texture basis against jax.grad,
    rtol 1e-7, float64; nvol saturates on some rays and not on others."""
    a = _arrays()
    gj = jax_basis_grid(a)
    o, d = _rays()
    w = np.random.default_rng(12).standard_normal((o.shape[0], 3))
    opt_kw = OPTS[opt_name]
    fields = ("density_data", "sh_data", "basis_data")

    def loss(vals):
        out = JCm.BACKENDS[mode](gj.replace(**dict(zip(fields, vals))),
                                 at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                 at.RenderOptions(**opt_kw))
        return jnp.sum(out["rgb"] * w), out

    (_, ref), ref_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tuple(getattr(gj, f) for f in fields))
    g = SparseGrid.from_numpy(a, device="cpu")
    params = [getattr(g, f).requires_grad_(True) for f in fields]
    got = TCm.BACKENDS[mode](g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw))
    assert set(got) == set(ref)
    for k in KEYS[mode]:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    grads = torch.autograd.grad(torch.sum(got["rgb"] * t64(w)), params)
    for f, r, t in zip(fields, ref_g, grads):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, f
        np.testing.assert_allclose(t.numpy(), r, rtol=1e-7, atol=1e-10 * np.abs(r).max(),
                                   err_msg=f)
    if mode == "nvol":
        alpha = got["alpha"].detach().numpy()
        assert (alpha == 1.0).any() and ((alpha > 0) & (alpha < 1)).any()
    np.testing.assert_allclose(got["rgb"].detach().numpy()[48],
                               opt_kw["background_brightness"], rtol=1e-12)  # a miss


@pytest.mark.parametrize("mode", MODES)
def test_float32_compat_render_matches_jax(mode):
    """A float32 grid and rays: the plain march against JAX's float32 scan.
    Tolerance: rtol 1e-5 / atol 1e-6 on rgb, alpha and log_transmit, atol
    1e-4 on depth (t up to ~20 grid units): the same float32 operations,
    with XLA free to fuse and reorder the trilerp's and the basis's sums;
    svox1's truncated voxel index and every step's t are equal in both."""
    a = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
             else v) for k, v in _arrays().items()}
    gj = jax_basis_grid(a, jnp.float32)
    o, d = (x.astype(np.float32) for x in _rays())
    opt_kw = OPTS["thresh"]
    ref = JCm.BACKENDS[mode](gj, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                             at.RenderOptions(**opt_kw))
    g = SparseGrid.from_numpy(a, device="cpu", dtype=torch.float32)
    got = TCm.BACKENDS[mode](g, pt.Rays(torch.as_tensor(o), torch.as_tensor(d)),
                             pt.RenderOptions(**opt_kw))
    for k in KEYS[mode]:
        tol = dict(rtol=1e-5, atol=1e-4 if k == "depth" else 1e-6)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **tol)


def test_volume_render_dispatch():
    """volume_render's five backends give their renderer's outputs, its
    kwargs pass through, and an unknown name raises as JAX's does."""
    a = dict(_arrays(), surface_type=defs.SURFACE_TYPE_SDF)
    g = SparseGrid.from_numpy(a, device="cpu")
    o, d = np_rays(8, seed=2)
    rays = pt.Rays(t64(o), t64(d))
    opt = pt.RenderOptions(**OPTS["thresh"])
    assert set(TCm.BACKENDS) == set(JCm.BACKENDS) == set(MODES)
    for name, fn in (("nvol", pt.volume_render_nvol), ("svox1", pt.volume_render_svox1),
                     ("cuvol", pt.volume_render_cuvol)):
        got, want = pt.volume_render(g, rays, opt, name), fn(g, rays, opt)
        np.testing.assert_array_equal(got["rgb"].numpy(), want["rgb"].numpy(), err_msg=name)
    got = pt.volume_render(g, rays, opt, "nvol", max_steps=3)
    np.testing.assert_array_equal(got["rgb"].numpy(),
                                  pt.volume_render_nvol(g, rays, opt, max_steps=3)["rgb"].numpy())
    surf = TCm.volume_render(g, rays, opt, "surface")
    compact = TCm.volume_render(g, rays, opt, "surf_trav", max_intersect_voxels=64)
    assert surf["rgb"].shape == compact["rgb"].shape == (8, 3)
    with pytest.raises(ValueError, match=r"unknown backend 'octree' \(have \['cuvol', 'nvol', "
                                         r"'surf_trav', 'surface', 'svox1'\]\)"):
        pt.volume_render(g, rays, opt, "octree")
    with pytest.raises(ValueError, match="unknown backend"):
        JCm.volume_render(jax_grid(a), at.Rays(jnp.asarray(o), jnp.asarray(d)),
                          at.RenderOptions(**OPTS["thresh"]), "octree")


@pytest.mark.parametrize("reso", [8, 16])
def test_to_svox1_npz_matches_jax(tmp_path, reso):
    """The port's N3Tree file equals the JAX package's array by array (the
    port builds the tree level by level in numpy, JAX node by node), on a
    sphere-bounded density grid; a surface grid and a non-power-of-two grid
    are refused, as in JAX."""
    from test_torch_cuvol_step import _grid

    gj = _grid(reso)
    a = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
             else v) for k, v in jax_to_np(gj).items()}
    g = SparseGrid.from_numpy(a, device="cpu")
    rj = jax_to_svox1_npz(gj, str(tmp_path / "j.npz"))
    rt = to_svox1_npz(g, str(tmp_path / "t.npz"))
    assert rt == rj and rt["n_nodes"] > 1
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="surface grids"):
        to_svox1_npz(SparseGrid.from_numpy(np_grid(8, basis_dim=4), device="cpu"),
                     str(tmp_path / "s.npz"))
    with pytest.raises(AssertionError, match="power-of-two"):
        to_svox1_npz(SparseGrid.from_numpy(np_grid(6, basis_dim=4), device="cpu"),
                     str(tmp_path / "p.npz"))
