"""The port's extraction and evaluation (``alphasurf_torch.geometry``: the
occupied cells, the iso points of K9g's plain version, the Chamfer distance
and the downsample; the apps ``extract_points``, ``eval_cf`` and
``combine_points``) against the JAX package's, on the CPU.

The iso points of a surface grid are equal bit for bit when the grid is
float64 (both packages return float32 points of the same float64 roots);
from a float32 grid, to atol 1e-6 in grid units (XLA's and PyTorch's
float32 roots differ in the last bit at coordinates up to 16). A grid
without a surface solves for density = threshold and then tests density
>= threshold at that very root, so each of its points is a tie decided by
the last bit of an 8-term sum that JAX leaves to XLA's dot (which rounds
with fused multiply-adds); there the rays agree everywhere but at such
ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.app import combine_points as j_combine
from alphasurf_tpu.app import eval_cf as j_eval_cf
from alphasurf_tpu.app import extract_points as j_extract_points
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_tpu.geometry import chamfer as JC
from alphasurf_tpu.geometry import extract as JE
from alphasurf_torch.app import combine_points, eval_cf, extract_points
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.geometry import chamfer as TC
from alphasurf_torch.geometry import extract as TE
from alphasurf_torch.utils.io import save_grid
from test_torch_util import jax_grid, jax_to_np, np_grid


def both(a, dtype=jnp.float64):
    gj = jax_grid(a, dtype)
    return gj, SparseGrid.from_numpy(jax_to_np(gj), device="cpu")


@pytest.mark.parametrize("case", ["gt16", "pruned"])
def test_occupied_cells_matches_jax(case):
    a = jax_to_np(jax_make_gt_grid(16)) if case == "gt16" else np_grid(16, seed=4, prune=0.2)
    gj, gt = both(a)
    got = TE.occupied_cells(gt)
    assert got.dtype == torch.int64
    ref = JE.occupied_cells(gj)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.size <= 15 ** 3


@pytest.mark.parametrize("n,dtype,kw", [
    (3, jnp.float64, dict(density_thresh=0.5)),
    (5, jnp.float64, dict(density_thresh=0.5)),
    (5, jnp.float64, dict(density_thresh=-1e9, surf_lv_set=0.3)),
    (3, jnp.float64, dict(density_thresh=0.5, surf_lv_set=-0.2, to_world=True,
                          scene_scale=2.0 / 3.0)),
    (5, jnp.float32, dict(density_thresh=0.5, surf_lv_set=0.2)),
    (3, jnp.float32, dict(density_thresh=0.5, to_world=True, scene_scale=2.0 / 3.0)),
])
def test_extract_iso_points_matches_jax(n, dtype, kw):
    """A pruned SDF grid with a perturbed surface and random density, off
    the unit cube (radius and centre), in batches of 300 cells: the JAX
    package pads its last batch, the port does not."""
    a = np_grid(16, seed=1, prune=0.15)
    a["radius"] = np.array([1.0, 1.25, 0.75])
    a["center"] = np.array([0.1, -0.2, 0.05])
    gj, gt = both(a, dtype)
    kw = dict(dict(to_world=False), **kw)
    ref = JE.extract_iso_points(gj, n_sample=n, batch=300, **kw)
    got = TE.extract_iso_points(gt, n_sample=n, batch=300, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape and len(ref) > 100
    if dtype == jnp.float64:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_extract_density_grid_matches_jax_but_at_ties():
    """A grid without a surface: the same points on every ray but those
    whose kept root's density lies within rounding of the threshold."""
    a = np_grid(16, seed=2)
    a["surface_data"] = a["level_set_data"] = None
    gj, gt = both(a)
    thresh = 1.5
    cells = JE.occupied_cells(gj)
    ref = np.asarray(JE._extract_cell_points(gj, jnp.asarray(cells, jnp.int32), 3, thresh, 0.0))
    got = TE._extract_cell_points(gt, torch.as_tensor(cells), 3, thresh, 0.0).numpy()
    nan_r, nan_g = np.isnan(ref).any(-1), np.isnan(got).any(-1)
    same = nan_r == nan_g
    np.testing.assert_array_equal(got[same & ~nan_g], ref[same & ~nan_r])
    assert (~same).mean() < 0.05 and (~nan_r).sum() > 1000
    # every differing ray's point (from whichever package has one) lies at
    # the threshold: its trilinear density equals it to float64 rounding
    pts = np.where(nan_r[..., None], got, ref)[~same]
    dens = np.asarray(a["density_data"])[:, 0]
    links = np.asarray(a["links"])
    l = np.minimum(np.floor(pts).astype(int), 14)
    f = pts - l
    val = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                val = val + w * dens[links[l[:, 0] + dx, l[:, 1] + dy, l[:, 2] + dz]]
    np.testing.assert_allclose(val, thresh, rtol=1e-12)
    # and extract_iso_points keeps them in the same order
    assert TE.extract_iso_points(gt, n_sample=3, density_thresh=thresh).shape[1] == 3


def test_chamfer_and_downsample_match_jax():
    """A seeded cloud with points on the cell boundaries of the downsample,
    where the float32 points' float64 cells decide."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    pts[:500] = (np.round(pts[:500] / 0.01) * 0.01).astype(np.float32)
    gt = rng.normal(size=(3000, 3)).astype(np.float32)
    for r in (0.01, 0.05, 0.0):
        got, ref = TC.downsample_points(pts, r), JC.downsample_points(pts, r)
        np.testing.assert_array_equal(got, ref)
    assert len(TC.downsample_points(pts, 0.05)) < len(pts)
    assert TC.chamfer(pts, gt) == JC.chamfer(pts, gt)
    assert TC.chamfer(pts[:0], gt) == JC.chamfer(pts[:0], gt)


def test_extract_and_eval_apps_match_jax(tmp_path):
    """A checkpoint the port saved, through both packages' extract_points
    (float32 grids, .npy and .ply outputs, a downsample) and eval_cf."""
    a = np_grid(16, seed=5, prune=0.1)
    ckpt = tmp_path / "ckpt.npz"
    save_grid(SparseGrid.from_numpy(a, device="cpu"), str(ckpt), step_id=7)
    gt_path = tmp_path / "gt.npy"
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2000, 3))
    np.save(gt_path, (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))
    for out, extra in (("a.npy", []), ("b.ply", ["--downsample", "0.02", "--n_sample", "3"])):
        got = extract_points.main([str(ckpt), "--out", str(tmp_path / f"t_{out}"), "--device",
                                   "cpu", *extra])
        ref = j_extract_points.main([str(ckpt), "--out", str(tmp_path / f"j_{out}"), *extra])
        assert got.shape == ref.shape and len(ref) > 100
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        cf = eval_cf.main([str(tmp_path / f"t_{out}"), str(gt_path), "--downsample", "0.01"])
        cf_j = j_eval_cf.main([str(tmp_path / f"j_{out}"), str(gt_path), "--downsample", "0.01"])
        for k in ("d2s", "s2d", "overall"):
            np.testing.assert_allclose(cf[k], cf_j[k], rtol=1e-6)
    head = [(tmp_path / f"{p}_b.ply").read_text().splitlines()[:7] for p in "tj"]
    assert head[0] == head[1]
    with pytest.raises(NotImplementedError, match="item 8"):
        extract_points.main([str(ckpt), "--mesh", str(tmp_path / "m.obj"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_points.main([str(ckpt)])  # the default device is the card


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        TE.marching_tetrahedra(np.zeros((4, 4, 4)))
    with pytest.raises(NotImplementedError, match="item 8"):
        TE.extract_mesh(None)


def test_combine_points_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    sets = [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for n in (800, 1200)]
    sets.append(sets[0][:300] + np.float32(1e-4))  # near-duplicates
    for d in (0.001, 0.05, 0.0):
        np.testing.assert_array_equal(combine_points.combine(sets, d), j_combine.combine(sets, d))
    paths = []
    for i, s in enumerate(sets):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], s)
    out = tmp_path / "c.npy"
    got = combine_points.main(paths + ["--downsample_density", "0.05", "--out", str(out)])
    np.testing.assert_array_equal(np.load(out), got)
    assert len(got) < sum(len(s) for s in sets)
