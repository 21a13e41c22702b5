"""K3, K4, K5a and K5b on the card against their plain versions (K5:
autograd of the plain renderer) and each other, at test size, on pools
whose rays span several of K4's and K5a's lane groups and on every surface
type. Marked ``cuda``: they need a card and skip without
one. The file imports nothing of JAX (its inputs come from numpy seeds and
the port's own grid makers), so that it also runs on a card machine without
JAX, where the tests' conftest cannot load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lanes.py
"""
import numpy as np
import pytest
import torch

import alphasurf_torch as pt
from alphasurf_torch import defs, kernels
from alphasurf_torch.app.bench_k34 import backward_check, pick_disagreements
from alphasurf_torch.core.grid import SparseGrid, create_grid
from alphasurf_torch.core.rays import Camera
from alphasurf_torch.data.synthetic import make_gt_grid, pose_spherical
from alphasurf_torch.render import surface as S

BASE = dict(sigma_thresh=-1e9, stop_thresh=-1.0, near_clip=0.0)
SMP_KEYS = ("t", "alpha", "contrib", "fake", "counted", "rgb", "snorm", "loss_e")
# the surface types' cases of tests/test_torch_types.py: type, initialiser,
# render options; the gate cases put raw alphas on both sides of
# sigma_thresh (UDF_ALPHA: level sets around single_lv's and their table)
CASES = {
    "plane": (defs.SURFACE_TYPE_PLANE, "sphere", {}),
    "udf": (defs.SURFACE_TYPE_UDF, "single_lv", {}),
    "udf_alpha_gate": (defs.SURFACE_TYPE_UDF_ALPHA, "single_lv",
                       dict(sigma_thresh=1e-8, surf_fake_sample=True, limited_fake_sample=True)),
    "udf_fake_sample_gate": (defs.SURFACE_TYPE_UDF_FAKE_SAMPLE, "single_lv_multi_sphere",
                             dict(sigma_thresh=1e-8, surf_fake_sample=True)),
    "voxel_face": (defs.SURFACE_TYPE_VOXEL_FACE, None, {}),
}
GATE_LEVEL_OFFSETS = (-1.0, -0.5, 0.0, 0.5, 1.0)
GATE_TABLE = (0.9, -0.6, 1.2, -1.1, 0.7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def sphere_arrays(reso, seed, prune):
    """numpy arrays of make_gt_grid's SDF sphere (basis_dim 9), pruned at
    random, with raw alpha 2 N(0, 1) + 1 and the surface perturbed."""
    a = make_gt_grid(reso, basis_dim=9, dtype=torch.float64, device="cpu").to_numpy()
    rng = np.random.default_rng(seed)
    links = a["links"].reshape(-1)
    keep = rng.random(links.size) >= prune
    cap = int(keep.sum())
    new = np.full(links.size, -1, np.int32)
    new[keep] = np.arange(cap, dtype=np.int32)
    rows = links[keep]
    return {**a, "links": new.reshape(a["links"].shape),
            "density_data": rng.standard_normal((cap, 1)) * 2.0 + 1.0,
            "sh_data": a["sh_data"][rows],
            "surface_data": a["surface_data"][rows] + rng.standard_normal((cap, 1)) * 0.3,
            "fake_sample_std": np.full((1, 1), 0.4), "truncated_vol_render_a": np.asarray(1.5)}


def type_arrays(name, reso=8, seed=0):
    """numpy arrays of a ``name`` grid: create_grid with the case's
    initialiser, SH 0.3 N(0, 1), the surface perturbed (PLANE's offset d
    only), raw alpha scaled per row, fake_sample_std 0.3; the gate cases'
    level sets, table and alphas as CASES says."""
    stype, init, _ = CASES[name]
    rng = np.random.default_rng(seed)
    a = create_grid(reso, surface_type=stype, surface_init=init, basis_dim=4, init_sigma=1.5,
                    dtype=torch.float64, device="cpu").to_numpy()
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


def sphere_rays(n=64, seed=1, dist=2.5):
    """Rays from outside the [-1, 1] cube toward its inner half."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * dist
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def type_rays(n=8):
    """The n x n rays of the types' trainability camera."""
    cam = Camera.make(pose_spherical(25.0, 15.0, 2.7), fx=30.0 * n / 24, width=n, height=n)
    rays = cam.gen_rays(device="cpu")
    return rays.origins.double().numpy(), rays.dirs.double().numpy()


def _slot_case(device, a, opt, o, d):
    """A float32 grid on ``device``, the plain pool of the rays and the plain
    K3 slots of that pool."""
    a = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
             else v) for k, v in a.items()}
    g = SparseGrid.from_numpy(a, device=device)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=device),
                   torch.as_tensor(d, dtype=torch.float32, device=device))
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, _ = S._prep(g, rays, opt)
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    inputs = tuple(x.contiguous() for x in (origins, dirs, sh_mult))
    pool = S._compact_crossings_plain(g.reso, inputs[0], inputs[1], tn.contiguous(),
                                      tx.contiguous(), S._occupancy_words_plain(g, opt))
    packed = S.pack_grid_data(g).detach().contiguous()
    sp = S._voxel_samples_plain(g, opt, pool, *inputs, ngt, packed)
    return g, pool, inputs + (ngt,), packed, sp


def _long_pool_case(device):
    """make_gt_grid's sphere at 32^3, every voxel occupied (alphas + 2),
    three level sets, 64 rays: pools of up to ~40 entries a ray, kills
    mid-ray at stop_thresh 0.3."""
    a = {**sphere_arrays(32, seed=3, prune=0.0), "level_set_data": np.array([-0.3, 0.0, 0.3])}
    a["density_data"] = a["density_data"] + 2.0
    opt = pt.RenderOptions(**{**BASE, "stop_thresh": 0.3, "truncated_vol_render": True,
                              "surf_fake_sample": True, "limited_fake_sample": False,
                              "surf_fake_sample_min_vox_len": 0.0})
    o, d = sphere_rays(64, seed=4)
    g, pool, inputs, packed, sp = _slot_case(device, a, opt, o, d)
    assert int((pool.offsets[1:] - pool.offsets[:-1]).max()) > 32
    return g, opt, pool, sp, _chunk(g, opt, pool, inputs, packed)


def _chunk(g, opt, pool, inputs, packed) -> dict:
    """bench_k34's description of a chunk: the grid, options, pool and K3's inputs."""
    origins, dirs, sh_mult, ngt = inputs
    return dict(grid=g, opt=opt, pool=pool, origins=origins, dirs=dirs, sh_mult=sh_mult, ngt=ngt,
                packed=packed)


def _type_case(device, name):
    """A chunk of type ``name`` ("sdf" or a CASES name) at sigma_thresh 1e-8
    with raw alphas on both sides of it, so that the corner gate and the
    slot gate act (UDF_ALPHA: its table's rows on both sides), truncation
    on: the grid, options, plain pool, K3's inputs, packed rows and plain
    slots. SDF's rows are SH (basis_dim 9, the kernels' compile-time row),
    the types' basis_dim 4."""
    if name == "sdf":
        a, (o, d), extra = sphere_arrays(16, seed=3, prune=0.2), sphere_rays(64, seed=4), {}
    else:
        a, (o, d), extra = type_arrays(name), type_rays(8), dict(CASES[name][2])
    if not name.endswith("_gate"):
        a["density_data"] = np.random.default_rng(2).uniform(-1.0, 2.0, a["density_data"].shape)
    assert (a["density_data"] < 1e-8).any() and (a["density_data"] > 1e-8).any()
    opt = pt.RenderOptions(**{**BASE, "sigma_thresh": 1e-8, "stop_thresh": 1e-7,
                              "truncated_vol_render": True, **extra})
    g, pool, inputs, packed, sp = _slot_case(device, a, opt, o, d)
    return g, opt, pool, inputs, packed, sp


def _close(got, ref, rtol=1e-4, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(got.detach().cpu().double().numpy(),
                               ref.detach().cpu().double().numpy(), rtol=rtol, atol=atol,
                               err_msg=err_msg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(0, False, None), (2, True, 8), (1, True, 3)])
def test_composite_on_long_pools_matches_plain_version(cuda, mode):
    """K4 on pools of up to ~40 entries a ray (several groups of its 16
    lanes), with every option on: truncation, fake samples, a stop_thresh
    kill mid-ray, the sigma-thresh depth, the live flags and alphas, per-ray
    background colours, and the walks' count window, first-maximum mode and
    first-K cache (K = 3 overflows). Against the plain version on the same
    card under chip_smoke.py's tolerances (float32 sums in other orders):
    values rtol 1e-4 / atol 1e-5, depths and loss sums atol 1e-4, picks
    atol 1e-3; counts, flags and cache rows' counts equal."""
    g, opt, pool, sp, _ = _long_pool_case(cuda)
    smp = {k: sp[k].contiguous() for k in SMP_KEYS}
    bg = torch.rand((64, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    ta = g.truncated_vol_render_a.detach()
    kernels.reset_launches()
    ck = kernels.composite(pool.offsets, smp, ta, opt, 0.2, True, *mode, bg_rgb=bg,
                           want_live_alpha=True)
    assert kernels.LAUNCHES["composite"] == 1
    cp = S._composite_plain(opt, ta, pool.offsets, sp, 0.2, *mode, bg_rgb=bg)
    np.testing.assert_array_equal(ck["n_intersections"].cpu().numpy(),
                                  cp["n_intersections"].cpu().numpy())
    np.testing.assert_array_equal(ck["live"].cpu().numpy(), cp["live"].cpu().numpy())
    assert int(cp["live"].sum()) < int(sp["contrib"].sum())  # kills mid-ray
    for k in ("rgb", "normal", "log_T", "weight", "live_alpha"):
        _close(ck[k], cp[k], err_msg=k)
    for k in ("depth", "ray_losses"):
        _close(ck[k], cp[k], atol=1e-4, err_msg=k)
    for k in ("depth_mode", "depth_med", "depth_sigma_thresh") + (
            ("cache_med",) if mode[2] else ()):
        _close(ck[k], cp[k], atol=1e-3, err_msg=k)
    if mode[2]:
        for k in ("n_cached", "fake_mask"):
            np.testing.assert_array_equal(ck["cache"][k].cpu().numpy(),
                                          cp["cache"][k].cpu().numpy())
        for k in ("ts", "alphas", "weights"):
            _close(ck["cache"][k], cp["cache"][k], atol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_backward_ray_picks_are_composite_picks(cuda):
    """K5a re-derives K4's stop_thresh kill and its one-sample picks (the
    mode by both rules, the median, the sigma-thresh depth, the cache's
    median) with K4's sums in K4's order: on the long pools, with kills
    mid-ray, no ray's kill or pick differs from K4's (bench_k34's
    pick_disagreements)."""
    g, opt, pool, sp, _ = _long_pool_case(cuda)
    smp = {k: sp[k].contiguous() for k in SMP_KEYS}
    got = pick_disagreements(pool, smp, g.truncated_vol_render_a.detach(), opt)
    assert got == dict.fromkeys(("kill", "mode", "med", "sig", "mode_first", "cache_med"), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sdf", "plane", "udf", "udf_alpha_gate", "udf_fake_sample_gate",
                                  "voxel_face"])
def test_phase_b_and_composite_every_type_with_alpha_gate(cuda, name):
    """K3 on every surface type at sigma_thresh 1e-8 with raw alphas on both
    sides of it, so that the corner gate (a voxel needs an alpha above the
    threshold) and the slot gate act (UDF_ALPHA: its table's rows on both
    sides), against the plain version on the same card: flags equal, values
    to chip_smoke.py's RTOL / ATOL (t to 1e-5 / 1e-4), loss sums to 1e-4;
    then K4 on the plain slots to the same tolerances. SDF's rows are SH
    (basis_dim 9, K3's compile-time row), the types' basis_dim 4."""
    g, opt, pool, (origins, dirs, sh_mult, ngt), packed, sp = _type_case(cuda, name)
    kernels.reset_launches()
    sk = kernels.phase_b(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs, sh_mult,
                         g.links, packed, S._surface_spec(g), g.level_set_data, ngt, S._fss(g),
                         opt)
    assert kernels.LAUNCHES["phase_b"] == 1
    if name != "sdf":
        assert kernels.LAUNCHES[f"phase_b_{name.replace('_gate', '')}"] == 1
    gated = bool(((sp["counted"] > 0) & ~sp["contrib"]).any())  # a root the slot gate drops
    assert bool(sp["contrib"].any()) and (gated or name == "voxel_face")
    for k in ("contrib", "fake", "counted"):
        np.testing.assert_array_equal(sk[k].cpu().numpy(), sp[k].cpu().numpy(), err_msg=k)
    live = sp["contrib"] | (sp["counted"] > 0)
    _close(sk["t"][live], sp["t"][live], rtol=1e-5, atol=1e-4, err_msg="t")
    for k in ("alpha", "rgb", "snorm"):
        _close(sk[k], sp[k], err_msg=k)
    _close(sk["loss_e"], sp["loss_e"], atol=1e-4, err_msg="loss_e")
    smp = {k: sp[k].contiguous() for k in SMP_KEYS}
    ta = g.truncated_vol_render_a.detach()
    ck = kernels.composite(pool.offsets, smp, ta, opt)
    cp = S._composite_plain(opt, ta, pool.offsets, sp)
    np.testing.assert_array_equal(ck["n_intersections"].cpu().numpy(),
                                  cp["n_intersections"].cpu().numpy())
    for k in ("rgb", "log_T", "weight"):
        _close(ck[k], cp[k], err_msg=k)
    _close(ck["ray_losses"], cp["ray_losses"], atol=1e-4, err_msg="ray_losses")


def _check_backward(got: dict, every: bool, type_name: str | None = None) -> None:
    """The launches of one backward_check and its verdict under GRAD_*."""
    assert kernels.LAUNCHES["backward_ray"] == 1 and kernels.LAUNCHES["backward_entry"] == 1
    if every:
        assert kernels.LAUNCHES["backward_ray_out"] == 1
        assert kernels.LAUNCHES["backward_entry_out"] == 1
    if type_name is not None:
        assert kernels.LAUNCHES[f"backward_entry_{type_name}"] == 1
    assert got["live_flips"] == 0
    assert got["ok"], {k: v for k, v in got.items() if k != "calls"}


@pytest.mark.cuda
@pytest.mark.parametrize("every", [False, True])
@pytest.mark.parametrize("rules", ["packed", "walk"])
def test_backward_on_long_pools_matches_autograd_of_plain_version(cuda, rules, every):
    """K5a and K5b on the long pools (rays of up to ~40 entries, several of
    K5a's lane groups; truncation, fake samples, a stop_thresh kill
    mid-ray) against autograd of the plain renderer on the same card, under
    chip_smoke.py's GRAD_* (bench_k34.backward_check): random cotangents
    on rgb and every ray loss, then (``every``) on every other output
    too, through the second instantiations: depth, normal, log_T, the
    mode, median and sigma-thresh depths, the slots' t, alphas and weights
    and the intersections' points, or, by the walks' rules (a count window
    of 2 entries, the first-maximum mode, a 3-sample cache, which
    overflows), the cache, its median and the samples' alphas."""
    g, opt, pool, _, c = _long_pool_case(cuda)
    mode = S.PACKED if rules == "packed" else S._Mode(2, True, 3)
    kernels.reset_launches()
    got = backward_check(c, every, mode, 0.2)
    _check_backward(got, every)
    assert kernels.LAUNCHES["backward_cache"] == (rules == "walk" and every)


@pytest.mark.cuda
@pytest.mark.parametrize("every", [False, True])
@pytest.mark.parametrize("name", ["sdf", "plane", "udf", "udf_alpha_gate", "udf_fake_sample_gate",
                                  "voxel_face"])
def test_backward_every_type_matches_autograd_of_plain_version(cuda, name, every):
    """K5a and K5b on every surface type's chunk (the alpha gates acting)
    against autograd of the plain renderer on the same card, under
    chip_smoke.py's GRAD_*, as the long pools' test: each type's template
    instantiation of K5b, on SDF's compile-time SH row (basis_dim 9) and
    the types' row of basis_dim 4, rgb-only and with every output's
    cotangent (the normal through K5b's second instantiation)."""
    g, opt, pool, inputs, packed, _ = _type_case(cuda, name)
    kernels.reset_launches()
    got = backward_check(_chunk(g, opt, pool, inputs, packed), every, S.PACKED, 0.2)
    _check_backward(got, every, None if name == "sdf" else name.replace("_gate", ""))

