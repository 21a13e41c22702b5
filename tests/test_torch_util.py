"""Shared inputs of the PyTorch-port tests, and the tests of the port's grid.

Every input is made from a numpy seed (or from the JAX package's
``make_gt_grid``) and handed to both packages as the same numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import torch

import alphasurf_tpu as at
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_torch.core.grid import CORNER_OFFSETS, SparseGrid

# One intra-op thread for the port's CPU ops: the tests run in several
# pytest-xdist workers at once, and a pool of one OpenMP thread a core in
# each worker oversubscribes the cores, every test then waiting on the
# others' spinning threads (one thread took the port's summed test time
# from 2,985 s to 1,041 s under -n 6 on an 8-core machine). It also fixes
# the order of the port's CPU sums.
torch.set_num_threads(1)

# the option sets of tests/test_surface_packed.py::test_packed_matches_dense
# plus the serving options of bench.py / render_imgs
BASE = dict(sigma_thresh=-1e9, stop_thresh=-1.0, near_clip=0.0)
OPTION_SETS = [
    dict(),
    dict(surf_fake_sample=True, limited_fake_sample=False, surf_fake_sample_min_vox_len=0.0),
    dict(truncated_vol_render=True, trunc_vol_weight_min=1e-10,
         surf_fake_sample=True, limited_fake_sample=True),
    dict(only_outward_intersect=True, stop_thresh=1e-4),
    dict(only_outward_intersect=True, surf_fake_sample=True, limited_fake_sample=True,
         truncated_vol_render=True, stop_thresh=1e-7),
]


def np_grid(reso=16, seed=0, prune=0.15, basis_dim=9, n_lv=1):
    """float64 numpy arrays of a pruned SDF sphere grid with random raw
    alpha, perturbed surface and the JAX ``make_gt_grid`` SH colours; rows
    in flat order, as both packages keep them."""
    g = jax_make_gt_grid(reso, basis_dim=basis_dim)
    rng = np.random.default_rng(seed)
    links = np.asarray(g.links).reshape(-1)
    keep = rng.random(links.size) >= prune
    cap = int(keep.sum())
    new = np.full(links.size, -1, np.int32)
    new[keep] = np.arange(cap, dtype=np.int32)
    rows = links[keep]
    return {
        "links": new.reshape(g.links.shape),
        "density_data": rng.standard_normal((cap, 1)) * 2.0 + 1.0,
        "sh_data": np.asarray(g.sh_data, np.float64)[rows],
        "surface_data": np.asarray(g.surface_data, np.float64)[rows]
        + rng.standard_normal((cap, 1)) * 0.3,
        "level_set_data": np.linspace(0.0, 0.6, n_lv),
        "fake_sample_std": np.full((1, 1), 0.4),
        "truncated_vol_render_a": np.asarray(1.5),
        "radius": np.ones(3),
        "center": np.zeros(3),
        "basis_dim": basis_dim,
        "surface_type": at.defs.SURFACE_TYPE_SDF,
    }


def jax_grid(a: dict, dtype=jnp.float64) -> at.SparseGrid:
    def f(k):
        return None if a.get(k) is None else jnp.asarray(a[k], dtype)

    return at.SparseGrid(
        links=jnp.asarray(a["links"]),
        density_data=f("density_data"),
        sh_data=f("sh_data"),
        surface_data=f("surface_data"),
        level_set_data=f("level_set_data"),
        fake_sample_std=f("fake_sample_std"),
        truncated_vol_render_a=f("truncated_vol_render_a"),
        radius=f("radius"),
        center=f("center"),
        basis_dim=a["basis_dim"],
        surface_type=a["surface_type"],
    )


def jax_to_np(g: at.SparseGrid) -> dict:
    """numpy arrays of a JAX grid, keyed by field name."""
    out = {}
    for k in ("links", "density_data", "sh_data", "surface_data", "level_set_data",
              "fake_sample_std", "truncated_vol_render_a", "radius", "center"):
        v = getattr(g, k)
        out[k] = None if v is None else np.asarray(v)
    out["basis_dim"] = g.basis_dim
    out["surface_type"] = g.surface_type
    return out


def np_rays(n=64, seed=1, dist=2.5):
    """Rays from outside the [-1, 1] cube toward its inner half."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * dist
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def lattice_rays(n, reso, seed):
    """Grid-space rays from lattice points (and half-way points) along
    diagonals and axes, so that planes of two or three axes are crossed at
    the same t; every seventh ray misses (tmax = -1)."""
    rng = np.random.default_rng(seed)
    dirs = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, -1], [1, 1, 0], [0, 0, 1], [-1, 0, 0],
                     [2, 1, 1], [1, 2, 2]], np.float32)
    o = rng.integers(0, reso - 1, (n, 3)).astype(np.float32)
    o[1::5] += 0.5
    d = dirs[rng.integers(0, len(dirs), n)]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tn = np.zeros(n, np.float32)
    tx = rng.uniform(1.0, 2.0 * reso, n).astype(np.float32)
    tx[::7] = -1.0
    return o, d, tn, tx


def corner_camera_rays(n_side=8):
    """The near-axis camera of test_packed_corner_crossings_camera (48x48,
    through the lattice centre): its central n_side x n_side rays, which
    cross voxel corners within roundoff."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.5
    rays = at.Camera.make(jnp.asarray(c2w), fx=60.0, width=48, height=48).gen_rays()
    lo = 24 - n_side // 2
    idx = (np.arange(lo, lo + n_side)[:, None] * 48 + np.arange(lo, lo + n_side)[None, :]).reshape(-1)
    return (np.asarray(rays.origins, np.float64)[idx], np.asarray(rays.dirs, np.float64)[idx])


def t64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# the port's grid
# ---------------------------------------------------------------------------

def test_corner_offsets_match():
    from alphasurf_tpu.core.grid import CORNER_OFFSETS as J

    np.testing.assert_array_equal(CORNER_OFFSETS, J)


def test_from_numpy_round_trip_and_dtype():
    a = np_grid(8, seed=3)
    g = SparseGrid.from_numpy(a, device="cpu")
    assert g.dtype == torch.float64 and g.links.dtype == torch.int32
    assert isinstance(g, torch.nn.Module)
    assert {n for n, _ in g.named_parameters()} == {
        "density_data", "sh_data", "surface_data", "fake_sample_std"}
    b = g.to_numpy()
    for k, v in a.items():
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(v), err_msg=k)
    g32 = SparseGrid.from_numpy(a, device="cpu", dtype=torch.float32)
    assert g32.sh_data.dtype == torch.float32


def test_world_grid_maps_match_jax():
    a = np_grid(8)
    a["radius"] = np.array([1.0, 1.5, 0.75])
    a["center"] = np.array([0.1, -0.2, 0.3])
    gj, gt = jax_grid(a), SparseGrid.from_numpy(a, device="cpu")
    pts = np.random.default_rng(0).uniform(-2, 2, (64, 3))
    np.testing.assert_allclose(gt.world2grid(t64(pts)).numpy(),
                               np.asarray(gj.world2grid(jnp.asarray(pts))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gt.grid2world(t64(pts)).numpy(),
                               np.asarray(gj.grid2world(jnp.asarray(pts))), rtol=1e-12, atol=1e-12)
    gp = np.random.default_rng(1).uniform(-1, 9, (64, 3))
    np.testing.assert_array_equal(gt.within_grid(t64(gp)).numpy(),
                                  np.asarray(gj.within_grid(jnp.asarray(gp))))


def test_make_gt_grid_matches_jax():
    from alphasurf_torch.data.synthetic import make_gt_grid

    ref = jax_to_np(jax_make_gt_grid(16, seed=2, basis_dim=9))
    got = make_gt_grid(16, seed=2, basis_dim=9, device="cpu").to_numpy()
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# renderer outputs
# ---------------------------------------------------------------------------

# a grid and option set where stop_thresh kills rays mid-walk, so that the
# renderers' counting rules under the kill (the dense walk per voxel, the
# compact renderer per voxel_chunk pass, the packed one over every entry)
# give different n_intersections
STOP_SETS = [
    dict(stop_thresh=0.3),
    dict(stop_thresh=0.05, surf_fake_sample=True, limited_fake_sample=False,
         surf_fake_sample_min_vox_len=0.0, truncated_vol_render=True),
]


def dense_grid(reso=12, seed=3):
    """np_grid with denser alpha and three level sets: rays die mid-walk."""
    a = np_grid(reso, seed=seed, prune=0.2)
    a["density_data"] = a["density_data"] + 2.0
    a["level_set_data"] = np.array([-0.3, 0.0, 0.3])
    return a


def assert_outputs_match(got: dict, ref: dict, rtol=1e-8, atol=1e-10, skip=()):
    """Every key of the JAX output (nested ray_losses, cache, samples)
    against the port's: integer and bool arrays equal, floats to rtol."""
    assert set(ref) - set(skip) <= set(got), set(ref) - set(got)
    for k, v in ref.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            assert set(v) == set(got[k]), (k, set(v) ^ set(got[k]))
            assert_outputs_match(got[k], v, rtol, atol)
            continue
        a = np.asarray(v)
        b = got[k]
        b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)
