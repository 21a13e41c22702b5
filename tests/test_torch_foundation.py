"""The port's foundation (rays, dda, trilerp, cubic, SH) against the JAX
package on the same float64 inputs, and the port's rules."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.core.sh import eval_sh_bases as j_sh
from alphasurf_tpu.ops import dda as jdda
from alphasurf_tpu.ops.cubic import _cubic_roots_raw as j_roots
from alphasurf_tpu.ops.cubic import cubic_coeffs_T as j_coeffs
from alphasurf_tpu.ops.trilerp import trilerp_weights_T as j_tw
from alphasurf_tpu.render.surface import _prep as j_prep
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.core.sh import eval_sh_bases as t_sh
from alphasurf_torch.ops import dda as tdda
from alphasurf_torch.ops.cubic import _cubic_roots_raw as t_roots
from alphasurf_torch.ops.cubic import cubic_coeffs_T as t_coeffs
from alphasurf_torch.ops.trilerp import trilerp_weights_T as t_tw
from alphasurf_torch.render.surface import _prep as t_prep
from test_torch_util import jax_grid, np_grid, np_rays, t64

TOL = dict(rtol=1e-12, atol=1e-12)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **{**TOL, **kw})


def test_dda_and_prep_match_jax():
    a = np_grid(12)
    gj, gt = jax_grid(a), SparseGrid.from_numpy(a, device="cpu")
    o, d = np_rays(64, seed=4)
    o[:4] = 0.0  # origins inside the grid
    d[4] = [1.0, 0.0, 0.0]  # axis-aligned: zero direction components
    jo, jd, jv, jds = jdda.preprocess_rays(gj, jnp.asarray(o), jnp.asarray(d))
    to, td, tv, tds = tdda.preprocess_rays(gt, t64(o), t64(d))
    for x, y in ((to, jo), (td, jd), (tv, jv), (tds, jds)):
        _close(x.numpy(), y)
    for x, y in zip(tdda.ray_bounds(gt, to, td), jdda.ray_bounds(gj, jo, jd)):
        _close(x.numpy(), y)
    for x, y in zip(tdda.spheric_bounds(gt, to, td, 0.1), jdda.spheric_bounds(gj, jo, jd, 0.1)):
        _close(x.numpy(), y)
    lv = np.random.default_rng(0).integers(0, 11, (64, 3)).astype(np.int32)
    for x, y in zip(tdda.voxel_plane_ts(to, td, torch.as_tensor(lv)),
                    jdda.voxel_plane_ts(jo, jd, jnp.asarray(lv))):
        _close(x.numpy(), y)
    for spheric in (False, True):
        opt_kw = dict(use_spheric_clip=spheric, near_clip=0.05)
        rj = j_prep(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(**opt_kw))
        rt = t_prep(gt, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw))
        for i in (0, 1, 2, 3, 4, 6, 7):
            _close(np.asarray(rt[i]), rj[i], err_msg=f"_prep[{i}] spheric={spheric}")
        _close(rt[5], float(rj[5]))


def test_trilerp_weights_match_jax():
    pos = np.random.default_rng(2).uniform(0, 1, (3, 5, 7))
    _close(t_tw(t64(pos)).numpy(), j_tw(jnp.asarray(pos)))


def test_cubic_coeffs_and_roots_match_jax():
    rng = np.random.default_rng(3)
    n = 512
    s8 = rng.standard_normal((8, n))
    u = rng.uniform(0, 1, (3, n))
    d = rng.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :16] = np.array([[1.0], [0.0], [0.0]])  # axis-aligned: cubic degenerates
    d[:, 16:32] = np.array([[0.6], [0.8], [0.0]])  # two axes: quadratic
    fj = j_coeffs(jnp.asarray(s8), jnp.asarray(u), jnp.asarray(d))
    ft = t_coeffs(t64(s8), t64(u), t64(d))
    for x, y in zip(ft, fj):
        _close(x.numpy(), y)
    f = [np.array(x) for x in fj]
    f[3][32:40] = 0.0
    f[2][32:36] = 0.0  # linear
    f[1][32:34] = 0.0  # constant: no root
    rj, hj = j_roots(*[jnp.asarray(x) for x in f], axis=0)
    rt, ht = t_roots(*[t64(x) for x in f])
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    _close(rt.numpy(), rj, rtol=1e-12, atol=1e-11)
    assert np.asarray(hj).sum(axis=0).min() == 0 and np.asarray(hj).sum(axis=0).max() == 3


@pytest.mark.parametrize("basis_dim", [1, 4, 9, 16, 25])
def test_sh_bases_match_jax(basis_dim):
    d = np.random.default_rng(basis_dim).standard_normal((40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(t_sh(basis_dim, t64(d)).numpy(), j_sh(basis_dim, jnp.asarray(d)))


def test_camera_rays_match_jax():
    from alphasurf_tpu.data.synthetic import pose_spherical as j_pose
    from alphasurf_torch.data.synthetic import pose_spherical as t_pose

    c2w = t_pose(40.0, 25.0, 2.7)
    np.testing.assert_array_equal(c2w, j_pose(40.0, 25.0, 2.7))
    jc = at.Camera.make(jnp.asarray(c2w), fx=30.0, fy=28.0, cx=11.0, width=24, height=20)
    tc = pt.Camera.make(c2w, fx=30.0, fy=28.0, cx=11.0, width=24, height=20)
    jr, tr = jc.gen_rays(), tc.gen_rays(device="cpu")
    np.testing.assert_array_equal(tr.origins.numpy(), np.asarray(jr.origins))
    np.testing.assert_array_equal(tr.dirs.numpy(), np.asarray(jr.dirs))
    # float32 on both sides: the device path is float32 in both packages
    jd, td = jc.gen_rays_device(), tc.gen_rays_device(device="cpu")
    np.testing.assert_allclose(td.origins.numpy(), np.asarray(jd.origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.dirs.numpy(), np.asarray(jd.dirs), rtol=0, atol=1e-6)


def test_host_rays_are_contiguous():
    """The kernels take contiguous rays only; the host-made origins were a
    broadcast copied in column-major order."""
    rays = pt.Camera.make(np.eye(4), fx=30.0, width=24, height=20).gen_rays(device="cpu")
    assert rays.origins.is_contiguous() and rays.dirs.is_contiguous()


def test_port_imports_neither_jax_nor_the_jax_package():
    """No file of the port names JAX or the JAX package; chip_smoke.py names
    the JAX package once, as data (its kernels' "replaces" paths and its
    check that neither was imported), and imports neither."""
    port = REPO / "alphasurf_torch"
    files = sorted(port.rglob("*.py")) + sorted((port / "csrc").glob("*.cu*"))
    assert len(files) > 10
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|alphasurf_tpu)\b", re.MULTILINE)
    offenders = [str(f.relative_to(REPO)) for f in files
                 if jax_import.search(f.read_text()) or "alphasurf_tpu" in f.read_text()]
    assert not offenders, offenders
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not jax_import.search(smoke)
    assert smoke.count("alphasurf_tpu") == 1 and 'JAX_PACKAGE = "alphasurf_tpu"' in smoke
    assert not re.search(r"import_module|__import__", smoke)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    a = np_grid(8)
    g = SparseGrid.from_numpy(a, device="cpu")
    cam = pt.Camera.make(np.eye(4, dtype=np.float32), fx=10.0, width=4, height=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.render_image(g, cam, pt.RenderOptions())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseGrid.from_numpy(a)
