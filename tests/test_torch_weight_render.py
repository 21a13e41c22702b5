"""The port's camera sweeps (``alphasurf_torch.core.weight_render``: K9c weight
march, K9d visibility walk, K9e transmittance march) against the JAX
package's, on the CPU.

The weight march runs in float32 in both packages whatever the grid's
dtype, on equal ray set-ups, so weights agree to float32 rounding: XLA's
and PyTorch's exp differ in the last bit on about 1 in 10 inputs, and a
sample's weight T (1 - exp(-sigma step)) cancels in its second factor, so
one ulp of exp near 1 (6e-8) is up to 3e-5 relative at sigma step ~ 2e-3
(rtol 1e-4, atol 1e-7); the keep mask at the Config's threshold is equal.
Visibility counts are integers and equal exactly; the cameras have 128 x
128 rays, one chunk of the JAX sweep, which then pads none (the JAX package
pads its last chunk with copies of the last ray, which the port does not
do). The transmittance march is float32 in both packages too (the JAX
package's fails on a float64 grid: its scan carry is float32), and its
maxima are products of float32 exps that differ in the last bit between
XLA and PyTorch: rtol 2e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.core import weight_render as JW
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_tpu.render.surface import all_crossings as jax_all_crossings
from alphasurf_torch.core import weight_render as W
from alphasurf_torch.core.grid import SparseGrid
from test_torch_topology import both, orbit_cameras
from test_torch_util import jax_grid, jax_to_np, np_rays


def density_volume(reso, seed):
    """A dense density volume with a ball of sigma ~ 20 and noise."""
    rng = np.random.default_rng(seed)
    c = (np.asarray(reso) - 1) / 2.0
    X, Y, Z = np.meshgrid(*[np.arange(r) for r in reso], indexing="ij")
    r = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
    return (20.0 / (1.0 + np.exp(2.0 * (r - min(reso) / 4.0)))
            + np.abs(rng.standard_normal(reso))).astype(np.float32)


@pytest.mark.parametrize("reso,stop", [((16, 16, 16), 0.2), ((12, 14, 10), 0.0)])
def test_grid_weight_render_matches_jax(reso, stop):
    vol = density_volume(reso, 1)
    cj, ct = orbit_cameras(24)
    off, sc = np.asarray([0.5, 0.5, 0.5]), np.asarray([0.5, 0.5, 0.5])
    ref = np.asarray(JW.grid_weight_render(jnp.asarray(vol), cj, off, sc, stop_thresh=stop))
    got = W.grid_weight_render(torch.as_tensor(vol), ct, torch.as_tensor(off),
                               torch.as_tensor(sc), stop_thresh=stop).numpy()
    assert got.dtype == np.float32 and got.shape == reso
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    thresh = 0.0005 * 512 / reso[2]  # the Config's weight_thresh / z reso
    np.testing.assert_array_equal(got >= thresh, ref >= thresh)
    assert 0 < (ref >= thresh).sum() < ref.size


def test_all_crossings_matches_jax():
    """The visibility walk's segments, float64 rays from outside the
    lattice and from inside it; voxels where the segment is valid (an
    invalid segment's midpoint may be infinite)."""
    o, d = np_rays(64, seed=4)
    o = o * 4.0 + 8.0
    d = d * 4.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:8] = 7.3  # origins inside the lattice: tnear 0
    tn = np.where(np.arange(64) < 8, 0.0, 1.0)
    tx = np.full(64, 30.0)
    ref = jax_all_crossings((16, 16, 16), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn),
                            jnp.asarray(tx))
    got = W.all_crossings((16, 16, 16), *(torch.as_tensor(x) for x in (o, d, tn, tx)))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    valid = np.asarray(ref[2])
    assert valid.sum() > 64
    l_ref = np.stack([np.asarray(x) for x in ref[3]], -1)
    np.testing.assert_array_equal(got[3].numpy()[valid], l_ref[valid])
    np.testing.assert_array_equal(got[4].numpy()[valid], np.asarray(ref[4])[valid])


@pytest.mark.parametrize("dtype,n_lv", [(jnp.float64, 1), (jnp.float64, 2), (jnp.float32, 2)])
def test_visibility_render_matches_jax(dtype, n_lv):
    """make_gt_grid(16) with 10% of its links dropped and a perturbed SDF
    (one or two level sets), two 128x128 cameras: equal counts."""
    a = jax_to_np(jax_make_gt_grid(16, basis_dim=4))
    rng = np.random.default_rng(5)
    links = a["links"].reshape(-1)
    keep = rng.random(links.size) >= 0.1
    new = np.full(links.size, -1, np.int32)
    new[keep] = np.arange(keep.sum(), dtype=np.int32)
    a["links"] = new.reshape(16, 16, 16)
    for k in ("density_data", "sh_data", "surface_data"):
        a[k] = np.asarray(a[k], np.float64)[keep]
    a["surface_data"] = a["surface_data"] + 0.3 * rng.standard_normal(a["surface_data"].shape)
    a["level_set_data"] = np.asarray([0.0, 1.5][:n_lv])
    gj, _ = both(a)
    if dtype == jnp.float32:
        gj = gj.replace(**{k: getattr(gj, k).astype(jnp.float32) for k in (
            "density_data", "sh_data", "surface_data", "level_set_data", "radius", "center")})
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    cj, ct = orbit_cameras(128)
    ref = np.asarray(JW.sparse_grid_visibility_render_surf(gj, cj))
    got = W.sparse_grid_visibility_render_surf(gt, ct).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert ref.max() > 0 and (ref < 0.05 * ref.max()).any()  # occluded vertices


def transmit_grid():
    """make_gt_grid(16) in float32 with 10% of its links dropped and a raw
    density N(1, 2) (negative in places, read without a relu)."""
    a = jax_to_np(jax_make_gt_grid(16))
    rng = np.random.default_rng(3)
    links = a["links"].reshape(-1)
    keep = rng.random(links.size) >= 0.1
    new = np.full(links.size, -1, np.int32)
    new[keep] = np.arange(keep.sum(), dtype=np.int32)
    a["links"] = new.reshape(16, 16, 16)
    for k in ("sh_data", "surface_data"):
        a[k] = a[k][keep]
    a["density_data"] = (rng.standard_normal((int(keep.sum()), 1)) * 2.0 + 1.0).astype(np.float32)
    return a


@pytest.mark.parametrize("stop", [0.0, 0.3])
def test_sparse_grid_weight_render_matches_jax(stop):
    """Four 32x32 cameras, float32 grids; one 65,536-ray chunk of the JAX
    sweep, padded with copies of its last ray (a maximum does not see
    them)."""
    a = transmit_grid()
    gj = jax_grid(a, jnp.float32)
    gt = SparseGrid.from_numpy(a, device="cpu")
    cj, ct = orbit_cameras(32, 4)
    ref = np.asarray(JW.sparse_grid_weight_render(gj, cj, stop_thresh=stop))
    got = W.sparse_grid_weight_render(gt, ct, stop_thresh=stop).numpy()
    assert got.dtype == np.float32 and got.shape == (gt.capacity,)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert 0.1 < (ref > 0).mean() < 1 and ref.max() == 1.0
    # a float64 grid's march reads its density in float32
    g64 = SparseGrid.from_numpy(a, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(W.sparse_grid_weight_render(g64, ct, stop_thresh=stop).numpy(),
                                  got)


def test_unported_sweeps_raise():
    """K9f raises; K9e, ported, gives JAX's all-zero maxima without
    cameras."""
    gj, gt = both(jax_to_np(jax_make_gt_grid(8)))
    np.testing.assert_array_equal(W.sparse_grid_weight_render(gt, []).numpy(),
                                  np.asarray(JW.sparse_grid_weight_render(gj, [])))
    with pytest.raises(NotImplementedError, match="K9f"):
        W.sparse_grid_mask_render(gt, None, None)
