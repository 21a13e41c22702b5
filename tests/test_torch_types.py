"""The other surface types against the JAX package, float64 on the CPU:
PLANE, UDF, UDF_ALPHA, UDF_FAKE_SAMPLE and VOXEL_FACE (svox2's
surface_type branches; the JAX package's render/surface.py:469-770, 1149).

``create_grid``'s initialisers give JAX's rows bit for bit; K1's occupancy
is equal; the packed, compact and dense renders (rgb, depth, log_T, the
counts and every ray loss) and their gradients into density, surface, SH
and fake_sample_std agree to the tolerances stated at each comparison; so
does the udf-var loss with its gradient. Grids are 8^3 (the smallest on
which every type has occupied voxels on both sides of its surface), 64
rays of one 8x8 camera. VOXEL_FACE is held to the JAX functions, not to
the reference oracle (ROADMAP §3). tests/test_torch_cuda.py holds each
kernel branch against its plain version on a card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu import defs
from alphasurf_tpu.core.grid import create_grid as j_create_grid
from alphasurf_tpu.data.synthetic import pose_spherical
from alphasurf_tpu.losses import render_losses as JL
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid, create_grid
from alphasurf_torch.losses import render_losses as TL
from alphasurf_torch.render import surface as TS
from test_torch_util import jax_grid, jax_to_np, t64

# name: (surface type, initialiser, render options): the JAX trainability
# test's types, initialisers and options, UDF and UDF_FAKE_SAMPLE with
# theirs of the JAX surface-init test; udf_fake_sample adds the
# truncated-vol-render ramp; udf_sphere (the udf-var test's) unrestricted
# fake samples, under which every level set counts in the hull
CASES = {
    "plane": (defs.SURFACE_TYPE_PLANE, "sphere", {}),
    "udf": (defs.SURFACE_TYPE_UDF, "single_lv", {}),
    "udf_alpha": (defs.SURFACE_TYPE_UDF_ALPHA, "single_lv",
                  dict(surf_fake_sample=True, limited_fake_sample=True)),
    "udf_fake_sample": (defs.SURFACE_TYPE_UDF_FAKE_SAMPLE, "single_lv_multi_sphere",
                        dict(surf_fake_sample=True, truncated_vol_render=True)),
    "voxel_face": (defs.SURFACE_TYPE_VOXEL_FACE, None, {}),
    "udf_sphere": (defs.SURFACE_TYPE_UDF, "sphere", dict(surf_fake_sample=True)),
    # the alpha gates at the Config's sigma_thresh, alphas on both sides of
    # it (type_arrays): UDF_ALPHA's table (K1 tests its largest row, K3
    # takes no corner gate, slots and fake samples read their level set's
    # row) and UDF_FAKE_SAMPLE's corners
    "udf_alpha_gate": (defs.SURFACE_TYPE_UDF_ALPHA, "single_lv",
                       dict(sigma_thresh=1e-8, surf_fake_sample=True, limited_fake_sample=True)),
    "udf_fake_sample_gate": (defs.SURFACE_TYPE_UDF_FAKE_SAMPLE, "single_lv_multi_sphere",
                             dict(sigma_thresh=1e-8, surf_fake_sample=True)),
}
BASE_OPT = dict(sigma_thresh=-1e9, stop_thresh=1e-7)
# UDF_ALPHA's gate case: level sets half a unit apart around single_lv's,
# and their alphas, two of them below sigma_thresh
GATE_LEVEL_OFFSETS = (-1.0, -0.5, 0.0, 0.5, 1.0)
GATE_TABLE = (0.9, -0.6, 1.2, -1.1, 0.7)
PARAMS = ("density_data", "surface_data", "sh_data", "fake_sample_std")
RENDERERS = ("packed", "compact", "dense")
# every (type, initialiser) pair of the JAX create_grid
INIT_PAIRS = (
    [(defs.SURFACE_TYPE_SDF, i) for i in (None, "sphere", "single_sphere", "outwards",
                                          "plane_init", "random")]
    + [(defs.SURFACE_TYPE_PLANE, i) for i in (None, "random", "sphere")]
    + [(t, i) for t in (defs.SURFACE_TYPE_UDF, defs.SURFACE_TYPE_UDF_ALPHA,
                        defs.SURFACE_TYPE_UDF_FAKE_SAMPLE)
       for i in (None, "sphere", "single_lv", "single_lv_multi_sphere")]
    + [(defs.SURFACE_TYPE_VOXEL_FACE, None)]
)


def type_arrays(name: str, reso: int = 8, seed: int = 0) -> dict:
    """float64 numpy arrays of a ``name`` grid: JAX's create_grid with the
    case's initialiser, SH drawn from ``seed`` and the trainability test's
    perturbations (surface noise; PLANE's on its offset d only; raw alpha
    scaled per row; UDF_ALPHA's table at 1.0 before that), and a
    fake_sample_std of 0.3. The gate cases then set UDF_ALPHA's level sets
    and table to GATE_* and UDF_FAKE_SAMPLE's raw alpha uniform in [-3, 1]."""
    stype, init, _ = CASES[name]
    rng = np.random.default_rng(seed)
    a = jax_to_np(j_create_grid(reso, surface_type=stype, surface_init=init, basis_dim=4,
                                init_sigma=1.5, dtype=jnp.float64))
    a["sh_data"] = 0.3 * rng.standard_normal(a["sh_data"].shape)
    if stype == defs.SURFACE_TYPE_UDF_ALPHA:
        a["density_data"] = np.ones_like(a["density_data"])
    pert = 0.15 * rng.standard_normal(a["surface_data"].shape)
    if stype == defs.SURFACE_TYPE_PLANE:
        pert[:, :3] = 0.0
        pert[:, 3] *= 0.5
    a["surface_data"] = a["surface_data"] + pert
    a["density_data"] = a["density_data"] * (1.0 + 0.2 * rng.standard_normal(
        a["density_data"].shape))
    a["fake_sample_std"] = np.full((1, 1), 0.3)
    if name == "udf_alpha_gate":
        a["level_set_data"] = a["level_set_data"][0] + np.array(GATE_LEVEL_OFFSETS)
        a["density_data"] = np.array(GATE_TABLE)[:, None]
    elif name == "udf_fake_sample_gate":
        a["density_data"] = rng.uniform(-3.0, 1.0, a["density_data"].shape)
    return a


def type_rays(n: int = 8):
    """The n x n rays of the JAX trainability test's camera (float64)."""
    cam = at.Camera.make(pose_spherical(25.0, 15.0, 2.7), fx=30.0 * n / 24, width=n, height=n)
    rays = cam.gen_rays()
    return np.asarray(rays.origins, np.float64), np.asarray(rays.dirs, np.float64)


def _loss_weights(B: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (B, 3)), rng.uniform(0.5, 1.5, (12, B)) * 0.1


def _jax_render(renderer: str):
    return {"packed": functools.partial(JS.volume_render_surface_packed, entries_per_ray=64.0),
            "compact": functools.partial(JS.volume_render_surface_compact,
                                         max_intersect_voxels=32),
            "dense": JS.volume_render_surface}[renderer]


def _port_render(renderer: str):
    return {"packed": TS.volume_render_surface_packed,
            "compact": functools.partial(TS.volume_render_surface_compact,
                                         max_intersect_voxels=32),
            "dense": TS.volume_render_surface}[renderer]


@functools.lru_cache(maxsize=None)
def _jax_renders(name: str):
    """One jitted JAX program per case: each renderer's outputs and the
    gradient of its weighted loss (rgb and all twelve ray losses)."""
    _, _, opts = CASES[name]
    opt = at.RenderOptions(**{**BASE_OPT, **opts})
    keys = TS._RAY_LOSS_KEYS

    def run(g, o, d, w_rgb, w_rl):
        res = {}
        for r in RENDERERS:
            def loss(*p, r=r):
                out = _jax_render(r)(g.replace(**dict(zip(PARAMS, p))), at.Rays(o, d), opt)
                tot = jnp.sum(out["rgb"] * w_rgb)
                for i, k in enumerate(keys):
                    tot = tot + jnp.sum(out["ray_losses"][k] * w_rl[i])
                return tot, out

            (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
                *(getattr(g, k) for k in PARAMS))
            res[r] = (out, grads)
        return res

    return jax.jit(run)


@pytest.mark.parametrize("stype,init", INIT_PAIRS,
                         ids=[f"{t}-{i}" for t, i in INIT_PAIRS])
def test_create_grid_matches_jax(stype, init):
    """Every initialiser, with and without the sphere bound, float32 and
    float64: links, rows and level sets bit for bit (both run the same host
    numpy in the same order, the nearest-sphere search in blocks in the
    port); UDF_ALPHA's density is its (n_lv, 1) table."""
    for sphere in (False, True):
        for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
            gj = j_create_grid(12, surface_type=stype, surface_init=init,
                               use_sphere_bound=sphere, dtype=jd)
            g = create_grid(12, surface_type=stype, surface_init=init, use_sphere_bound=sphere,
                            dtype=td, device="cpu")
            assert g.surface_type == gj.surface_type
            for k in ("links", "density_data", "sh_data", "surface_data", "level_set_data"):
                want, got = np.asarray(getattr(gj, k)), getattr(g, k).detach().numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, k
                np.testing.assert_array_equal(got, want, err_msg=k)


def test_surface_init_cases_match_jax(monkeypatch):
    """The calls of the JAX package's tests/test_surface_init.py at their
    sizes, bit for bit, with the nearest-sphere search cut into blocks of
    100 vertices (the block size must not move a value); an unknown
    initialiser raises."""
    import alphasurf_torch.core.grid as G

    monkeypatch.setattr(G, "_NEAREST_CHUNK", 100)
    calls = [(12, defs.SURFACE_TYPE_SDF, "outwards"), (8, defs.SURFACE_TYPE_SDF, "plane_init"),
             (16, defs.SURFACE_TYPE_SDF, "single_sphere"), (16, defs.SURFACE_TYPE_UDF, "sphere"),
             (16, defs.SURFACE_TYPE_UDF, "single_lv"),
             (16, defs.SURFACE_TYPE_UDF, "single_lv_multi_sphere"),
             (8, defs.SURFACE_TYPE_UDF_ALPHA, "sphere"), (8, defs.SURFACE_TYPE_PLANE, "random"),
             (8, defs.SURFACE_TYPE_PLANE, "sphere"), (16, defs.SURFACE_TYPE_SDF, "sphere")]
    for reso, stype, init in calls:
        gj = j_create_grid(reso, surface_type=stype, surface_init=init)
        g = create_grid(reso, surface_type=stype, surface_init=init, device="cpu")
        for k in ("links", "density_data", "surface_data", "level_set_data"):
            np.testing.assert_array_equal(getattr(g, k).detach().numpy(),
                                          np.asarray(getattr(gj, k)), err_msg=f"{init} {k}")
    with pytest.raises(ValueError, match="bogus"):
        create_grid(8, surface_type=defs.SURFACE_TYPE_SDF, surface_init="bogus", device="cpu")


TYPES = ("plane", "udf", "udf_alpha", "udf_fake_sample", "voxel_face")


@pytest.mark.parametrize("name", TYPES + ("udf_alpha_gate", "udf_fake_sample_gate"))
def test_occupancy_and_renders_match_jax(name):
    """Each type, and the alpha gates at sigma_thresh 1e-8 (for UDF_ALPHA
    also a table wholly below it, which occupies no voxel in either
    package). K1's occupancy equal; each renderer's rgb, depth, normal, log_T,
    alpha and ray losses to rtol 1e-8 (atol 1e-10: sums of terms of order
    1 in another order), its counts equal; the gradients of a weighted sum
    of rgb and the twelve ray losses to rtol 1e-7 with a floor of 1e-10 of
    each gradient's largest entry (scatter-adds of up to a few hundred
    terms per row, summed in another order by XLA's scatter than by
    index_add)."""
    a = type_arrays(name)
    stype, _, opts = CASES[name]
    gj = jax_grid(a)
    o, d = type_rays()
    w_rgb, w_rl = _loss_weights(o.shape[0])
    opt = pt.RenderOptions(**{**BASE_OPT, **opts})

    occ_j = np.asarray(JS.voxel_occupancy(gj, at.RenderOptions(**{**BASE_OPT, **opts})))
    g = SparseGrid.from_numpy(a, device="cpu")
    np.testing.assert_array_equal(TS.voxel_occupancy(g, opt).numpy(), occ_j)
    assert occ_j.any()
    if name == "udf_alpha_gate":
        low = {**a, "density_data": -np.abs(a["density_data"])}
        occ_low = np.asarray(JS.voxel_occupancy(jax_grid(low), at.RenderOptions(**{**BASE_OPT,
                                                                                 **opts})))
        np.testing.assert_array_equal(
            TS.voxel_occupancy(SparseGrid.from_numpy(low, device="cpu"), opt).numpy(), occ_low)
        assert not occ_low.any()

    ref = _jax_renders(name)(gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(w_rgb),
                             jnp.asarray(w_rl))
    for r in RENDERERS:
        g = SparseGrid.from_numpy(a, device="cpu")
        params = [getattr(g, k).requires_grad_(True) for k in PARAMS]
        out = _port_render(r)(g, pt.Rays(t64(o), t64(d)), opt)
        loss = (out["rgb"] * t64(w_rgb)).sum()
        for i, k in enumerate(TS._RAY_LOSS_KEYS):
            loss = loss + (out["ray_losses"][k] * t64(w_rl[i])).sum()
        got = torch.autograd.grad(loss, params, allow_unused=True)
        out_j, grads_j = ref[r]
        for k in ("rgb", "depth", "normal", "log_transmit", "alpha"):
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(out_j[k]), rtol=1e-8,
                                       atol=1e-10, err_msg=f"{r} {k}")
        for k in ("n_intersections",) + (() if r == "dense" else ("n_occupied",)):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]),
                                          err_msg=f"{r} {k}")
        for k in TS._RAY_LOSS_KEYS:
            np.testing.assert_allclose(out["ray_losses"][k].detach().numpy(),
                                       np.asarray(out_j["ray_losses"][k]), rtol=1e-8,
                                       atol=1e-10, err_msg=f"{r} ray_losses[{k}]")
        for k, gk, gr in zip(PARAMS, got, grads_j):
            gr = np.asarray(gr)
            gk = np.zeros_like(gr) if gk is None else gk.numpy()
            np.testing.assert_allclose(gk, gr, rtol=1e-7, atol=1e-10 * np.abs(gr).max(),
                                       err_msg=f"{r} d/d{k}")
        assert np.asarray(out_j["n_intersections"]).sum() > 0, r
        if stype != defs.SURFACE_TYPE_VOXEL_FACE:
            assert np.abs(np.asarray(grads_j[1])).max() > 0, r  # the surface moves the image
        if stype in (defs.SURFACE_TYPE_UDF, defs.SURFACE_TYPE_UDF_ALPHA,
                     defs.SURFACE_TYPE_UDF_FAKE_SAMPLE):
            assert np.asarray(out_j["ray_losses"]["udf_var_cnt"]).sum() > 0, r


@pytest.mark.parametrize("limited", [True, False])
def test_udf_var_loss_and_gradient_match_jax(limited):
    """``udf_var_from_ray_losses`` of the packed render of a UDF sphere grid
    with 9 level sets 0.25 apart (so that a voxel's hull holds several),
    with limited fake samples (the hull count of each voxel) or unlimited
    ones (every level set counts), and its gradient into the surface rows,
    to rtol 1e-9 (value) and 1e-7 with a floor of 1e-10 of the largest
    entry (gradient: scatter-add order)."""
    a = type_arrays("udf_sphere", seed=4)
    a["level_set_data"] = np.linspace(2.0, 4.0, 9)
    gj = jax_grid(a)
    o, d = type_rays()
    opt = dict(BASE_OPT, surf_fake_sample=True, limited_fake_sample=limited)

    def j_loss(surf):
        out = JS.volume_render_surface_packed(gj.replace(surface_data=surf),
                                              at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                              at.RenderOptions(**opt), entries_per_ray=64.0)
        return JL.udf_var_from_ray_losses(out["ray_losses"])

    lj, gr = jax.jit(jax.value_and_grad(j_loss))(gj.surface_data)
    g = SparseGrid.from_numpy(a, device="cpu")
    g.surface_data.requires_grad_(True)
    out = TS.volume_render_surface_packed(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt))
    lt = TL.udf_var_from_ray_losses(out["ray_losses"])
    (gt,) = torch.autograd.grad(lt, [g.surface_data])
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-9)
    gr = np.asarray(gr)
    np.testing.assert_allclose(gt.numpy(), gr, rtol=1e-7, atol=1e-10 * np.abs(gr).max())
    assert float(lj) > 0 and np.abs(gr).max() > 0


@pytest.mark.parametrize("name", TYPES)
def test_checkpoints_carry_each_type(name, tmp_path):
    """A port checkpoint of each type loads in the JAX package and a JAX one
    in the port (utils/io.py, SparseGrid.from_numpy): the type, PLANE's 4
    surface channels, UDF_ALPHA's (n_lv, 1) density table, the level sets
    and fake_sample_std equal (SH as float16, as both store it)."""
    from alphasurf_tpu.utils import io as JIO
    from alphasurf_torch.utils import io as TIO

    a = type_arrays(name)
    a = {k: (v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64 else v)
         for k, v in a.items()}
    g = SparseGrid.from_numpy(a, device="cpu")
    TIO.save_grid(g, str(tmp_path / "t.npz"))
    gj, _ = JIO.load_grid(str(tmp_path / "t.npz"))
    JIO.save_grid(gj, str(tmp_path / "j.npz"))
    gt, _ = TIO.load_grid(str(tmp_path / "j.npz"), device="cpu")
    assert gj.surface_type == gt.surface_type == CASES[name][0]
    for k in ("links", "density_data", "surface_data", "level_set_data", "fake_sample_std"):
        np.testing.assert_array_equal(getattr(gt, k).detach().numpy(), np.asarray(getattr(gj, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(gt, k).detach().numpy(), a[k], err_msg=k)
    np.testing.assert_array_equal(gt.sh_data.numpy(), a["sh_data"].astype(np.float16))
