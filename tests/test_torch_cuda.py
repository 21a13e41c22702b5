"""The CUDA kernels against their plain versions at test size. Marked
``cuda``: they need a card and skip without one. chip_smoke.py runs the
same comparisons at the main path's shapes on machines without JAX."""
import numpy as np
import pytest
import torch

import alphasurf_torch as pt
from alphasurf_torch import kernels
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import surface as S
from test_torch_util import OPTION_SETS, BASE, lattice_rays, np_grid, np_rays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _float32(a):
    return {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
                else v) for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", OPTION_SETS)
def test_kernels_match_plain_versions(cuda, kw):
    a = _float32(np_grid(16, seed=3, prune=0.2))
    g = SparseGrid.from_numpy(a, device=cuda)
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    kernels.reset_launches()
    got = S.volume_render_surface_packed(g, rays, opt)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in ("occupancy", "phase_a_count", "phase_a_fill",
                                                 "phase_b", "composite")), kernels.LAUNCHES
    ref = S.volume_render_surface_packed(SparseGrid.from_numpy(a, device="cpu"),
                                         pt.Rays(rays.origins.cpu(), rays.dirs.cpu()), opt)
    for k in ("rgb", "depth", "normal", "log_transmit", "depth_mode", "depth_med"):
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["n_occupied"].cpu().numpy(), ref["n_occupied"].numpy())
    np.testing.assert_array_equal(got["n_intersections"].cpu().numpy(),
                                  ref["n_intersections"].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rays", ["camera", "lattice"])
def test_phase_a_pool_matches_plain_version_in_order(cuda, rays):
    """K2 (count, scan, fill) and K11b: the pool equal to the plain
    version's element for element in pool order, on camera rays and on
    lattice rays with exact ties between axes."""
    a = _float32(np_grid(16, seed=7, prune=0.1))
    g = SparseGrid.from_numpy(a, device=cuda)
    opt = pt.RenderOptions(**BASE)
    if rays == "camera":
        o, d = np_rays(64, seed=8)
        origins, dirs, _, tnear, tmax, _, ok, _ = S._prep(g, pt.Rays(
            torch.as_tensor(o, dtype=torch.float32, device=cuda),
            torch.as_tensor(d, dtype=torch.float32, device=cuda)), opt)
        inputs = (origins, dirs, *S._phase_a_bounds(tnear, tmax, ok))
    else:
        inputs = [torch.as_tensor(x, device=cuda) for x in lattice_rays(64, 16, seed=9)]
    inputs = [x.contiguous() for x in inputs]
    words = S.occupancy_words(g, opt)
    kernels.reset_launches()
    got = S.compact_crossings_packed(g, *inputs, words)
    capped = S.compact_crossings(g, *inputs, words, 3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["phase_a_fill"] == 1 and kernels.LAUNCHES["compact_fill"] == 1
    ref = S._compact_crossings_plain(g.reso, *inputs, words)
    assert ref.close_t.shape[0] > 0
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    for x, y in zip(capped, S._cap_pool(ref, 3)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", OPTION_SETS)
def test_backward_matches_autograd_of_plain_path(cuda, kw):
    """K5 (through the renderer's autograd Function) against autograd of the
    plain renderer on the same card."""
    a = _float32(np_grid(16, seed=3, prune=0.2))
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    names = ("density_data", "surface_data", "sh_data", "fake_sample_std")

    def grads(g, render):
        params = [getattr(g, n).requires_grad_(True) for n in names]
        out = render(g)
        loss = (out["rgb"] ** 2).sum() + 0.1 * out["ray_losses"]["l_dist"].sum() \
            + 0.1 * out["ray_losses"]["l_entropy_a"].sum() + 0.1 * out["ray_losses"]["lap_sum"].sum()
        return [torch.zeros_like(p) if x is None else x
                for p, x in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]

    g = SparseGrid.from_numpy(a, device=cuda)
    kernels.reset_launches()
    got = grads(g, lambda g: S.volume_render_surface_packed(g, rays, opt))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["backward_ray"] == 1 and kernels.LAUNCHES["backward_entry"] == 1

    def plain(g):
        origins, dirs, shm, tn, tx, ngt, ok, _ = S._prep(g, rays, opt)
        words = S.occupancy_words(g, opt)
        pool = S._compact_crossings_plain(g.reso, origins, dirs, torch.where(ok, tn, 0 * tn),
                                          torch.where(ok, tx, 0 * tx - 1), words)
        comp = S._render_plain(g, opt, pool, origins, dirs, shm, ngt, S.pack_grid_data(g))
        return {"rgb": comp["rgb"], "ray_losses": dict(zip(S._RAY_LOSS_KEYS, comp["ray_losses"]))}

    ref = grads(SparseGrid.from_numpy(a, device=cuda), plain)
    for n, x, r in zip(names, got, ref):
        np.testing.assert_allclose(x.cpu().numpy(), r.cpu().numpy(), rtol=1e-3, atol=1e-5, err_msg=n)


@pytest.mark.cuda
def test_regularizers_and_rmsprop_match_plain_versions(cuda):
    from alphasurf_torch.losses import reg as R
    from alphasurf_torch.optim.rmsprop import _rmsprop_plain

    g = SparseGrid.from_numpy(_float32(np_grid(16, seed=3, prune=0.1)), device=cuda)
    cells = R.sample_present_cells(None, g, R.row_coords_of(g), 0.3, start=5)
    n = cells.numel()
    lk, gk = kernels.reg_tv(g.links, cells, g.sh_data.detach(), 0, 27, None, 1.0 / n)
    g.sh_data.requires_grad_(True)
    lp = R._tv_plain(g, g.sh_data, cells, 0, 27, None, 1.0 / n)
    (gp,) = torch.autograd.grad(lp, [g.sh_data])
    g.sh_data.requires_grad_(False)
    np.testing.assert_allclose(float(lk), float(lp.detach()), rtol=1e-5)
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-4, atol=1e-7)
    lk, gk = kernels.reg_normal(g.links, cells, g.surface_data.detach(), g.level_set_data,
                                True, True, False, 1.0 / n)
    g.surface_data.requires_grad_(True)
    lp = R._normal_plain(g, cells, True, True, False, 1.0 / n)
    (gp,) = torch.autograd.grad(lp, [g.surface_data])
    g.surface_data.requires_grad_(False)
    np.testing.assert_allclose(float(lk), float(lp.detach()), rtol=1e-5)
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-4, atol=1e-7)
    grad = torch.randn_like(g.sh_data) * 1e-2
    p1, r1 = g.sh_data.detach().clone(), torch.zeros_like(grad)
    p2, r2 = p1.clone(), r1.clone()
    kernels.rmsprop(p1, r1, grad, 1e-2, 0.95, 1e-8, None, None, False)
    _rmsprop_plain(p2, r2, grad, 1e-2, 0.95, 1e-8, None, None, False)
    torch.testing.assert_close(p1, p2, rtol=1e-6, atol=0)
    torch.testing.assert_close(r1, r2, rtol=1e-6, atol=0)


def _cuvol_grid(device, reso=16, seed=0):
    """A sphere-bounded float32 warm-start grid with a blobby density
    (negative in places) and random SH of basis 9."""
    from alphasurf_torch.core.grid import create_grid

    g = create_grid(reso, use_sphere_bound=True, basis_dim=9, init_sigma=0.0, device="cpu")
    rng = np.random.default_rng(seed)
    links = g.links.numpy().reshape(-1)
    coords = np.stack(np.meshgrid(*[np.arange(reso)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = np.linalg.norm(coords - reso / 2.0, axis=-1)
    dens = np.maximum(0.0, 3.0 - np.abs(r - reso / 4.0)) * 2.0 + rng.standard_normal(r.shape) * 0.5
    a = g.to_numpy()
    a["density_data"] = dens[links >= 0, None].astype(np.float32)
    a["sh_data"] = (rng.standard_normal((g.capacity, 27)) * 0.3).astype(np.float32)
    return a, SparseGrid.from_numpy(a, device=device)


CUVOL_SETS = [dict(), dict(last_sample_opaque=True), dict(use_spheric_clip=True, near_clip=0.1),
              dict(step_size=0.3)]


@pytest.mark.cuda
def test_density_occupancy_kernel_matches_plain_version(cuda):
    from alphasurf_torch.render import cuvol as C

    a, g = _cuvol_grid(cuda)
    kernels.reset_launches()
    words = C.density_occupancy_words(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["density_occupancy"] == 1
    ref = C.density_occupancy_words(SparseGrid.from_numpy(a, device="cpu"))
    assert torch.equal(words.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stype", ["sdf", "plane", "udf", "udf_alpha", "udf_fake_sample",
                                   "voxel_face"])
def test_occupancy_kernel_matches_plain_version_bit_for_bit(cuda, stype):
    """K1's walk equal to its plain version, torch.equal, on the lattices
    of the CPU transcription (tests/occ_grids.py: 2^3 to 130^3, windows and
    runs that end early, Z % 4 both ways, links not 16-byte aligned) and its
    edge cases (an absent tile, a window's extra vertex alone, bit 31),
    every option set, both modes."""
    from occ_grids import check_k1_card

    assert check_k1_card(stype, cuda) > 0


@pytest.mark.cuda
def test_density_occupancy_walk_matches_plain_version_bit_for_bit(cuda):
    """K1d's walk likewise, on the same lattices and edge cases."""
    from occ_grids import check_k1d_card

    assert check_k1d_card(cuda) > 0


def _long_cuvol_case(device):
    """test_torch_cuvol_long's thin (72, 4, 4) grid in float32 and its rays
    along x, of 0, 1, 31, 32, 33, 64 and 65 entries and five of 71: K8's
    warps cross their 32-entry groups there."""
    from test_torch_cuvol_long import thin_grid, thin_rays

    a = _float32(thin_grid(basis_dim=9))
    return a, SparseGrid.from_numpy(a, device=device), thin_rays()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blobby", "long"])
@pytest.mark.parametrize("kw", CUVOL_SETS)
def test_cuvol_kernels_match_plain_versions(cuda, kw, case):
    """K8 forward and backward (through the renderer's autograd Function)
    and K10 against the plain renderers on the CPU, float32: on the blobby
    grid's 64 rays and on long rays of every group boundary."""
    from alphasurf_torch.render import cuvol as C

    if case == "long":
        a, g, (o, d) = _long_cuvol_case(cuda)
    else:
        a, g = _cuvol_grid(cuda)
        o, d = np_rays(64, seed=4)
    opt = pt.RenderOptions(**kw)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    rays_cpu = pt.Rays(rays.origins.cpu(), rays.dirs.cpu())
    cot = torch.randn(o.shape[0], 3, generator=torch.Generator().manual_seed(1))

    def grads(g, r):
        params = [g.density_data.requires_grad_(True), g.sh_data.requires_grad_(True)]
        out = C.volume_render_cuvol_packed(g, r, opt, depth_sigma_thresh=0.7)
        gr = torch.autograd.grad((out["rgb"] * cot.to(out["rgb"].device)).sum(), params)
        return out, [x.cpu() for x in gr]

    kernels.reset_launches()
    got, g_got = grads(g, rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cuvol_forward"] == 1 and kernels.LAUNCHES["cuvol_backward"] == 1
    ref, g_ref = grads(SparseGrid.from_numpy(a, device="cpu"), rays_cpu)
    for k in ("rgb", "depth", "log_transmit", "depth_sigma_thresh"):
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), ref[k].detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for name, x, r in zip(("density", "sh"), g_got, g_ref):
        np.testing.assert_allclose(x.numpy(), r.numpy(), rtol=1e-3, atol=1e-5, err_msg=name)
    g.density_data.requires_grad_(False)
    g.sh_data.requires_grad_(False)
    got = C.volume_render_cuvol(g, rays, opt, depth_sigma_thresh=0.7)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cuvol_march"] == 1
    ref = C.volume_render_cuvol(SparseGrid.from_numpy(a, device="cpu"), rays_cpu, opt,
                                depth_sigma_thresh=0.7)
    for k in ("rgb", "depth", "log_transmit", "depth_sigma_thresh"):
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", CUVOL_SETS)
@pytest.mark.parametrize("renderer", ["dense", "packed"])
def test_cuvol_output_cotangents_match_plain_versions(cuda, renderer, kw):
    """K10 backward and K8's depth/log_T instantiation (through the
    renderers' autograd Functions) with cotangents on rgb, depth and
    log_transmit, against autograd of the plain renderers on the CPU,
    float32, to K8's tolerances above."""
    from alphasurf_torch.render import cuvol as C

    a, g = _cuvol_grid(cuda)
    opt = pt.RenderOptions(**kw)
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    gen = torch.Generator().manual_seed(2)
    cot = {"rgb": torch.randn(64, 3, generator=gen), "depth": 0.1 * torch.randn(64, generator=gen),
           "log_transmit": 0.1 * torch.randn(64, generator=gen)}
    render = C.volume_render_cuvol if renderer == "dense" else C.volume_render_cuvol_packed

    def grads(g, r):
        params = [g.density_data.requires_grad_(True), g.sh_data.requires_grad_(True)]
        out = render(g, r, opt)
        loss = sum((out[k] * v.to(out[k].device)).sum() for k, v in cot.items())
        return [x.cpu() for x in torch.autograd.grad(loss, params)]

    kernels.reset_launches()
    got = grads(g, rays)
    torch.cuda.synchronize()
    counter = "cuvol_march_backward" if renderer == "dense" else "cuvol_backward_out"
    assert kernels.LAUNCHES[counter] == 1, kernels.LAUNCHES
    ref = grads(SparseGrid.from_numpy(a, device="cpu"), pt.Rays(rays.origins.cpu(),
                                                                 rays.dirs.cpu()))
    for name, x, r in zip(("density", "sh"), got, ref):
        np.testing.assert_allclose(x.numpy(), r.numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# K9a-K9d: the stage transitions
# ---------------------------------------------------------------------------

def _topology_grid(cuda, surface=True):
    from test_torch_topology import rand_grid

    a = _float32(rand_grid(5, surface=surface))
    return a, SparseGrid.from_numpy(a, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(alpha_thresh=0.8, dilate=2, max_elements=500),
                                dict(alpha_thresh=0.2, dilate=1, non_expanding=True),
                                dict(alpha_thresh=0.5, dilate=0, keep_lv_band=True)])
def test_resample_surface_kernels_match_plain_versions(cuda, kw):
    """K9a (mask, band) and K9b (every vertex, kept rows, touched flags)
    through resample_surface on the card against the plain path on the
    CPU: links equal, rows to float32 rounding of the same lerps."""
    from alphasurf_torch.core import topology as T

    a, g = _topology_grid(cuda)
    kernels.reset_launches()
    got = T.resample_surface(g, (14, 13, 16), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["keep_mask"] > 0 and kernels.LAUNCHES["resample_dense"] > 0
    assert kernels.LAUNCHES["resample_rows"] == 1
    assert (kernels.LAUNCHES["lv_band"] > 0) == bool(kw.get("keep_lv_band"))
    ref = T.resample_surface(SparseGrid.from_numpy(a, device="cpu"), (14, 13, 16), **kw)
    assert torch.equal(got.links.cpu(), ref.links)
    for f in ("density_data", "sh_data", "surface_data"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(), getattr(ref, f).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.cuda
def test_prune_and_weight_march_match_plain_versions(cuda):
    """K9a's prune rule through prune_grid, and K9c through resample with
    cameras, on the card against the CPU."""
    from alphasurf_torch.core import topology as T
    from alphasurf_torch.core import weight_render as W
    from test_torch_topology import orbit_cameras

    a, g = _topology_grid(cuda)
    cpu = SparseGrid.from_numpy(a, device="cpu")
    kernels.reset_launches()
    got = T.prune_grid(g, 1.0, 1, prune_surf=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prune_mask"] == 1
    assert torch.equal(got.links.cpu(), T.prune_grid(cpu, 1.0, 1, prune_surf=True).links)
    _, cams = orbit_cameras(32)
    vol = torch.rand((12, 13, 11), generator=torch.Generator().manual_seed(2)) * 20.0
    off, sc = torch.full((3,), 0.5), torch.full((3,), 0.5)
    wk = W.grid_weight_render(vol.to(cuda), cams, off, sc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["weight_march"] == len(cams)
    wp = W.grid_weight_render(vol, cams, off, sc)
    np.testing.assert_allclose(wk.cpu().numpy(), wp.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_visibility_kernel_matches_plain_version(cuda):
    """K9d against its plain version, both on the card: equal counts."""
    from alphasurf_torch.core import weight_render as W
    from alphasurf_torch.data.synthetic import make_gt_grid
    from alphasurf_torch.ops import dda
    from test_torch_topology import orbit_cameras

    g = make_gt_grid(16, device=cuda)
    _, cams = orbit_cameras(64)
    kernels.reset_launches()
    got = W.sparse_grid_visibility_render_surf(g, cams)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["visibility"] == len(cams)
    counts = torch.zeros(g.capacity, dtype=torch.int32, device=cuda)
    for cam in cams:
        r = cam.gen_rays(device=cuda)
        o, d, _, _ = dda.preprocess_rays(g, r.origins, r.dirs)
        tn, tx = dda.ray_bounds(g, o, d)
        ok = torch.isfinite(tn) & torch.isfinite(tx) & (tn <= tx)
        W._visibility_chunk_plain(g.links, g.surface_data[:, 0].detach(), g.level_set_data,
                                  counts, o, d, torch.where(ok, tn, torch.zeros_like(tn)),
                                  torch.where(ok, tx, torch.full_like(tx, -1.0)))
    assert torch.equal(got, counts.float())
    assert got.max() > 0


# ---------------------------------------------------------------------------
# K9e and K9g: the weight init's transmittance march and the iso points
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_transmit_march_matches_plain_version(cuda):
    """K9e through sparse_grid_weight_render on the card against the plain
    march on the same card: equal maxima (the same float32 operations and
    the device's expf)."""
    from alphasurf_torch.core import weight_render as W
    from test_torch_topology import orbit_cameras
    from test_torch_weight_render import transmit_grid

    a = transmit_grid()
    g = SparseGrid.from_numpy(a, device=cuda)
    _, cams = orbit_cameras(32, 4)
    kernels.reset_launches()
    got = W.sparse_grid_weight_render(g, cams)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transmit_march"] == len(cams)
    ref = W.sparse_grid_weight_render(SparseGrid.from_numpy(a, device="cpu"), cams)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=2e-6, atol=0)
    assert float(ref.max()) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,surface", [(3, True), (5, True), (3, False)])
def test_iso_points_match_plain_version(cuda, n, surface):
    """K9g through extract_iso_points on the card against its plain version
    on the same card, float32: equal points in the same order."""
    from alphasurf_torch.geometry import extract as E

    a = _float32(np_grid(16, seed=1, prune=0.15))
    if not surface:
        a["surface_data"] = a["level_set_data"] = None
    g = SparseGrid.from_numpy(a, device=cuda)
    cells = E.occupied_cells(g)
    kernels.reset_launches()
    got = E.extract_iso_points(g, n_sample=n, density_thresh=0.5, batch=300, to_world=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["iso_points"] == (cells.numel() + 299) // 300
    ref = np.concatenate([E._extract_cell_points(g, cells[s:s + 300], n, 0.5, 0.0).cpu().numpy()
                          .reshape(-1, 3) for s in range(0, cells.numel(), 300)])
    ref = ref[~np.isnan(ref).any(-1)]
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 100


# ---------------------------------------------------------------------------
# the DTU path: K9f, K3/K4's output options, the mesh
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_mask_march_matches_plain_version(cuda):
    """K9f through sparse_grid_mask_render on the card against the plain
    sweep on the same card, in chunks of 100 rays: equal masks."""
    from alphasurf_torch.core import weight_render as W
    from test_torch_dtu import _masked_rays

    a, g = _cuvol_grid(cuda)
    o, d, m = _masked_rays()
    kernels.reset_launches()
    got = W.sparse_grid_mask_render(g, torch.as_tensor(o[m]), torch.as_tensor(d[m]), chunk=100)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mask_march"] == (int(m.sum()) + 99) // 100
    ref = torch.zeros(g.capacity, dtype=torch.float32, device=cuda)
    for s in range(0, int(m.sum()), 100):
        rays = W._mask_rays(g, torch.as_tensor(o[m][s:s + 100], device=cuda),
                            torch.as_tensor(d[m][s:s + 100], device=cuda), 0.0)
        W._mask_chunk_plain(g.links, ref, *rays)
    assert torch.equal(got, ref) and 0 < float(got.sum()) < g.capacity


@pytest.mark.cuda
@pytest.mark.parametrize("kw", OPTION_SETS)
def test_render_options_match_plain_versions(cuda, kw):
    """K4's sigma-thresh depth and live flags and intersect_points through
    the renderer on the card against the plain path on the CPU, float32:
    the depth to the tolerance of the other depths, the intersections'
    mask equal and their points to 1e-5."""
    a = _float32(np_grid(16, seed=3, prune=0.2, n_lv=2))
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    out = {}
    for dev in (cuda, "cpu"):
        g = SparseGrid.from_numpy(a, device=dev)
        rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=dev),
                       torch.as_tensor(d, dtype=torch.float32, device=dev))
        kernels.reset_launches()
        out[str(dev)] = S.volume_render_surface_packed(g, rays, opt, depth_sigma_thresh=0.2,
                                                       return_intersections=True)
    assert kernels.LAUNCHES["composite_sigma_thresh"] == 0  # the CPU run launches nothing
    got, ref = out[str(cuda)], out["cpu"]
    np.testing.assert_allclose(got["depth_sigma_thresh"].cpu().numpy(),
                               ref["depth_sigma_thresh"].numpy(), rtol=1e-4, atol=1e-5)
    gi, ri = got["intersections"], ref["intersections"]
    np.testing.assert_array_equal(gi["mask"].cpu().numpy(), ri["mask"].numpy())
    m = ri["mask"]
    np.testing.assert_allclose(gi["pts"].cpu()[m].numpy(), ri["pts"][m].numpy(), atol=1e-5)
    for k in ("alpha", "weight"):
        np.testing.assert_allclose(gi[k].cpu()[m].numpy(), ri[k][m].numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_mesh_on_the_card_equals_the_cpu(cuda, tmp_path):
    """extract_mesh is plain torch: on the card it writes the CPU's OBJ."""
    from alphasurf_torch.geometry import extract as E

    a = _float32(np_grid(12, seed=1, prune=0.1))
    for dev, name in ((cuda, "g.obj"), ("cpu", "c.obj")):
        E.extract_mesh(SparseGrid.from_numpy(a, device=dev), str(tmp_path / name),
                       density_thresh=0.5)
    assert (tmp_path / "g.obj").read_bytes() == (tmp_path / "c.obj").read_bytes()


# ---------------------------------------------------------------------------
# K11a-K11d: the dense walk, the K-slot pool, the first-K cache and its
# gradient
# ---------------------------------------------------------------------------

def _k11_inputs(cuda, kw):
    from test_torch_util import dense_grid

    a = _float32(dense_grid(16))
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    return a, opt, rays


K11_RENDERERS = {
    "dense": lambda g, r, o, **kw: S.volume_render_surface(g, r, o, **kw),
    "compact": lambda g, r, o, **kw: S.volume_render_surface_compact(g, r, o,
                                                                     max_intersect_voxels=3,
                                                                     voxel_chunk=2, **kw),
    "packed": lambda g, r, o, **kw: S.volume_render_surface_packed(g, r, o, **kw),
}


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", sorted(K11_RENDERERS))
@pytest.mark.parametrize("kw", [OPTION_SETS[4], dict(stop_thresh=0.3)])
def test_k11_renderers_match_plain_versions(cuda, renderer, kw):
    """K11a (dense) and K11b (compact) pools equal to their plain versions
    bit for bit; the renders with K11c's cache within float32 rounding."""
    a, opt, rays = _k11_inputs(cuda, kw)
    render = K11_RENDERERS[renderer]
    kernels.reset_launches()
    got = render(SparseGrid.from_numpy(a, device=cuda), rays, opt, cache_size=8)
    torch.cuda.synchronize()
    pool_kernels = {"dense": ("dense_walk_count", "dense_walk_fill"), "compact": ("compact_fill",),
                    "packed": ("phase_a_fill",)}[renderer]
    assert all(kernels.LAUNCHES[k] > 0 for k in pool_kernels + ("composite_cache",))
    ref = render(SparseGrid.from_numpy(a, device="cpu"),
                 pt.Rays(rays.origins.cpu(), rays.dirs.cpu()), opt, cache_size=8)
    for k in ("rgb", "depth", "normal", "log_transmit", "depth_mode"):
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("ts", "alphas", "weights"):
        np.testing.assert_allclose(got["cache"][k].cpu().numpy(), ref["cache"][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("n_cached", "fake_mask"):
        np.testing.assert_array_equal(got["cache"][k].cpu().numpy(), ref["cache"][k].numpy())
    np.testing.assert_array_equal(got["n_intersections"].cpu().numpy(),
                                  ref["n_intersections"].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", sorted(K11_RENDERERS))
def test_k11_cache_gradients_match_autograd_of_plain_path(cuda, renderer):
    """K11d: rgb, ray-loss and both cache-loss gradients through K5 against
    autograd of the plain renderer on the CPU."""
    from alphasurf_torch.losses import render_losses as RL

    a, opt, rays = _k11_inputs(cuda, OPTION_SETS[4])
    render = K11_RENDERERS[renderer]
    names = ("density_data", "surface_data", "sh_data", "fake_sample_std")

    def grads(g, r):
        params = [getattr(g, n).requires_grad_(True) for n in names]
        out = render(g, r, opt, cache_size=8)
        loss = (out["rgb"] ** 2).sum() + 0.1 * out["ray_losses"]["l_dist"].sum() \
            + RL.l_conv_mode_samp_from_cache(out["cache"]) \
            + RL.l_samp_dist_from_cache(out["cache"]) + (out["cache"]["weights"] ** 2).sum()
        return [torch.zeros_like(p) if x is None else x
                for p, x in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]

    kernels.reset_launches()
    got = grads(SparseGrid.from_numpy(a, device=cuda), rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["backward_cache"] == 1
    ref = grads(SparseGrid.from_numpy(a, device="cpu"),
                pt.Rays(rays.origins.cpu(), rays.dirs.cpu()))
    for n, x, r in zip(names, got, ref):
        x, r = x.cpu().double(), r.double()
        assert float((x - r).norm()) <= 1e-3 * float(r.norm()) + 1e-6, n


def _basis_inputs(cuda, basis):
    """A float32 16^3 grid with a learned basis and 64 rays on the card."""
    from test_torch_basis import basis_arrays

    a = _float32(basis_arrays(np_grid(16, seed=3, prune=0.2, basis_dim=4), basis))
    if "basis_mlp" in a:
        a["basis_mlp"] = {k: np.asarray(v, np.float32) for k, v in a["basis_mlp"].items()}
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    return a, rays


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["texture", "mlp"])
@pytest.mark.parametrize("renderer", ["packed", "cuvol_packed"])
def test_basis_gradients_match_autograd_of_plain_path(cuda, renderer, basis):
    """K5b's and K8's sh_mult output: the learned basis's gradient through
    the renderer on the card against autograd of the plain path on the CPU
    (norm to 1e-3); the launch counted as the basis variant."""
    from alphasurf_torch.render import cuvol as C
    from test_torch_basis import basis_params

    a, rays = _basis_inputs(cuda, basis)
    opt = pt.RenderOptions(**{**BASE, **OPTION_SETS[1]}) if renderer == "packed" else \
        pt.RenderOptions(near_clip=0.05)
    render = S.volume_render_surface_packed if renderer == "packed" else \
        C.volume_render_cuvol_packed
    counter = "backward_entry_basis" if renderer == "packed" else "cuvol_backward_basis"

    def grads(g, r):
        params = list(basis_params(g).values()) + [g.sh_data]
        for p in params:
            p.requires_grad_(True)
        return torch.autograd.grad((render(g, r, opt)["rgb"] ** 2).sum(), params)

    kernels.reset_launches()
    got = grads(SparseGrid.from_numpy(a, device=cuda), rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == 1
    ref = grads(SparseGrid.from_numpy(a, device="cpu"),
                pt.Rays(rays.origins.cpu(), rays.dirs.cpu()))
    for x, r in zip(got, ref):
        x, r = x.cpu().double(), r.double()
        assert float(r.norm()) > 0 and float((x - r).norm()) <= 1e-3 * float(r.norm())


@pytest.mark.cuda
def test_basis_tv_kernel_matches_plain_version(cuda):
    """K12g against the plain texture TV: loss and gradient."""
    from alphasurf_torch.losses import reg as R
    from test_torch_basis import np_texture

    tex = torch.as_tensor(np_texture(R=8), dtype=torch.float32, device=cuda)
    lk, gk = kernels.reg_basis_tv(tex, 1.0 / 7 ** 3)
    t = tex.clone().requires_grad_(True)
    lp = R._basis_tv_plain(t)
    (gp,) = torch.autograd.grad(lp, [t])
    np.testing.assert_allclose(float(lk), float(lp.detach()), rtol=1e-5)
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nvol", "svox1"])
def test_compat_kernels_match_plain_versions(cuda, mode):
    """K14 forward and backward (density, SH, basis) against the plain march
    on the same card, float32."""
    from alphasurf_torch.render import compat as Cm

    a, rays = _basis_inputs(cuda, "texture")
    opt = pt.RenderOptions(step_size=0.5, sigma_thresh=0.1)
    names = ("density_data", "sh_data", "basis_data")

    def run(g):
        params = [getattr(g, n).requires_grad_(True) for n in names]
        out = Cm.BACKENDS[mode](g, rays, opt)
        return out, torch.autograd.grad((out["rgb"] ** 2).sum(), params)

    kernels.reset_launches()
    got, gk = run(SparseGrid.from_numpy(a, device=cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"compat_forward_{mode}"] == 1
    assert kernels.LAUNCHES[f"compat_backward_{mode}"] == 1
    g = SparseGrid.from_numpy(a, device=cuda)
    fn = Cm._nvol_plain if mode == "nvol" else Cm._svox1_plain
    params = [getattr(g, n).requires_grad_(True) for n in names]
    o, dd, ds, shm, tmin, tmax = Cm._march_setup(g, rays, mode == "svox1")
    rgb, _, acc = fn(g, opt, o, dd, ds, shm, tmin, tmax, Cm.max_steps_for(g, opt))
    rgb = rgb + ((1 - acc) if mode == "nvol" else torch.exp(acc))[:, None] * 1.0
    gp = torch.autograd.grad((rgb ** 2).sum(), params)
    np.testing.assert_allclose(got["rgb"].detach().cpu().numpy(), rgb.detach().cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    for x, r in zip(gk, gp):
        assert float((x - r).norm()) <= 1e-3 * float(r.norm()) + 1e-7


# the other surface types: (type, initialiser, render options), as
# chip_smoke.SURFACE_TYPES and tests/test_torch_types.py
SURFACE_TYPE_CASES = {
    "plane": (pt.defs.SURFACE_TYPE_PLANE, "sphere", {}),
    "udf": (pt.defs.SURFACE_TYPE_UDF, "single_lv", {}),
    "udf_alpha": (pt.defs.SURFACE_TYPE_UDF_ALPHA, "single_lv",
                  dict(surf_fake_sample=True, limited_fake_sample=True)),
    "udf_fake_sample": (pt.defs.SURFACE_TYPE_UDF_FAKE_SAMPLE, "single_lv_multi_sphere",
                        dict(surf_fake_sample=True)),
    "voxel_face": (pt.defs.SURFACE_TYPE_VOXEL_FACE, None, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,gate", [(n, False) for n in SURFACE_TYPE_CASES]
                         + [("udf_alpha", True), ("udf_fake_sample", True)])
def test_surface_type_branches_match_plain_versions(cuda, name, gate):
    """Each type's branches of K1 (words equal), K3 and K4 (the render, to
    1e-4) and K5 (the gradients of the rgb sum through the kernels, to 1e-3
    of each gradient's largest entry; float32 sums in other orders) against
    the plain versions on the same card, at 16^3 with SH and raw alpha from
    a seed. ``gate``: at sigma_thresh 1e-8 with alphas on both sides of it
    (UDF_ALPHA: 66 level sets, past K5b's per-warp table of 64, every third
    row of their table below; UDF_FAKE_SAMPLE: raw alpha in [-3, 1])."""
    from alphasurf_torch.core.grid import create_grid

    stype, init, opts = SURFACE_TYPE_CASES[name]
    g = create_grid(16, surface_type=stype, surface_init=init, basis_dim=4, device=cuda,
                    trainable_fake_sample_std=bool(opts))
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        g.sh_data.copy_(0.3 * torch.randn(g.sh_data.shape, generator=gen, device=cuda))
        if stype != pt.defs.SURFACE_TYPE_UDF_ALPHA:
            g.density_data.uniform_(-3.0 if gate else 0.5, 1.0 if gate else 3.0, generator=gen)
        else:
            g.density_data.fill_(1.0)
    if gate and stype == pt.defs.SURFACE_TYPE_UDF_ALPHA:
        i = torch.arange(66, device=cuda)
        g = g.replace(level_set_data=g.level_set_data[0] + 0.25 * (i - 33).float(),
                      density_data=torch.where(i % 3 == 1, -1.0, 1.0).float()[:, None])
    opt = pt.RenderOptions(sigma_thresh=1e-8 if gate else -1e9, stop_thresh=1e-7, **opts)
    assert torch.equal(S.occupancy_words(g, opt), S._occupancy_words_plain(g, opt))
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    params = [p for p in (g.density_data, g.surface_data, g.sh_data, g.fake_sample_std)
              if p is not None]
    kernels.reset_launches()
    for p in params:
        p.requires_grad_(True)
    got = S.volume_render_surface_packed(g, rays, opt)
    g_k = torch.autograd.grad(got["rgb"].sum(), params)
    assert kernels.LAUNCHES[f"phase_b_{name}"] > 0 and kernels.LAUNCHES[f"backward_entry_{name}"] > 0
    origins, dirs, sh_mult, tn, tx, ngt, ray_ok, _ = S._prep(g, rays, opt)
    words = S.occupancy_words(g, opt)
    pool = S.compact_crossings_packed(g, origins, dirs, torch.where(ray_ok, tn, 0 * tn),
                                      torch.where(ray_ok, tx, torch.full_like(tx, -1.0)), words)
    ref = S._render_plain(g, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(g))
    g_p = torch.autograd.grad(ref["rgb"].sum(), params)
    np.testing.assert_allclose(got["rgb"].detach().cpu().numpy(), ref["rgb"].detach().cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    for a_, b_ in zip(g_k, g_p):
        b_ = b_.cpu().numpy()
        np.testing.assert_allclose(a_.cpu().numpy(), b_, atol=1e-3 * max(np.abs(b_).max(), 1e-6))


# ---------------------------------------------------------------------------
# The output cotangents (K5a's and K5b's second instantiations, K14's) and
# return_samples on the card
# ---------------------------------------------------------------------------

OUT_RENDERERS = {
    "packed": lambda g, r, o: S.volume_render_surface_packed(
        g, r, o, cache_size=8, return_intersections=True, depth_sigma_thresh=0.5),
    "dense": lambda g, r, o: S.volume_render_surface(g, r, o, cache_size=8, return_samples=True),
    "compact": lambda g, r, o: S.volume_render_surface_compact(
        g, r, o, cache_size=8, return_samples=True, max_intersect_voxels=16),
}


def _out_grid(name, device):
    """A float32 16^3 grid of type ``name`` ("sdf", "plane" or "udf")."""
    if name == "sdf":
        return SparseGrid.from_numpy(_float32(np_grid(16, seed=3, prune=0.2)), device=device)
    from test_torch_types import type_arrays

    return SparseGrid.from_numpy(_float32(type_arrays(name, 16)), device=device)


def _every_output_loss(out, seed=0):
    """A weighted sum of every output that takes a cotangent: rgb, depth,
    normal, alpha, log_transmit, the mode and median depths, the
    sigma-thresh depth, the intersections (over their mask) and the
    samples."""
    gen = torch.Generator().manual_seed(seed)

    def w(x):
        return torch.rand(x.shape, generator=gen).to(x.device) - 0.5

    loss = 0.0
    for k in ("rgb", "depth", "normal", "alpha", "log_transmit", "depth_mode", "depth_med",
              "depth_sigma_thresh"):
        if k in out:
            loss = loss + (out[k] * w(out[k])).sum()
    if "intersections" in out:
        it = out["intersections"]
        v = torch.cos(it["pts"]).sum(-1) + 0.7 * it["alpha"] - 0.4 * it["weight"]
        loss = loss + torch.where(it["mask"], v, torch.zeros_like(v)).sum()
    for k in ("ts", "alphas", "weights"):
        if "samples" in out:
            loss = loss + (out["samples"][k] * w(out["samples"][k])).sum()
    return loss


@pytest.mark.cuda
@pytest.mark.parametrize("stype", ["sdf", "plane", "udf"])
@pytest.mark.parametrize("renderer", sorted(OUT_RENDERERS))
def test_output_cotangents_match_autograd_of_plain_path(cuda, renderer, stype):
    """Every output cotangent through K5 (backward_ray_out, and
    backward_entry_out for the normal) against autograd of the plain
    renderer on the CPU, float32, to 1e-3 of each gradient's norm; the
    returned samples equal the plain path's."""
    opt = pt.RenderOptions(**{**BASE, **(OPTION_SETS[4] if stype == "sdf" else {})})
    o, d = np_rays(64, seed=4)
    rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=cuda),
                   torch.as_tensor(d, dtype=torch.float32, device=cuda))
    render = OUT_RENDERERS[renderer]
    names = ("density_data", "surface_data", "sh_data", "fake_sample_std")

    def grads(g, r):
        params = [getattr(g, n).requires_grad_(True) for n in names]
        out = render(g, r, opt)
        return out, [torch.zeros_like(p) if x is None else x for p, x in zip(
            params, torch.autograd.grad(_every_output_loss(out), params, allow_unused=True))]

    kernels.reset_launches()
    out_k, got = grads(_out_grid(stype, cuda), rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["backward_ray_out"] == 1, kernels.LAUNCHES
    assert kernels.LAUNCHES["backward_entry_out"] == 1, kernels.LAUNCHES
    if stype != "sdf":
        assert kernels.LAUNCHES[f"backward_entry_out_{stype}"] == 1
    out_p, ref = grads(_out_grid(stype, "cpu"), pt.Rays(rays.origins.cpu(), rays.dirs.cpu()))
    for n, x, r in zip(names, got, ref):
        x, r = x.cpu().double(), r.double()
        assert float((x - r).norm()) <= 1e-3 * float(r.norm()) + 1e-6, n
    if "samples" in out_k:
        assert kernels.LAUNCHES["composite_samples"] == 1
        assert renderer != "dense" or kernels.LAUNCHES["dense_walk_fill_steps"] == 1
        for k in ("valid", "fake_mask"):
            np.testing.assert_array_equal(out_k["samples"][k].cpu().numpy(),
                                          out_p["samples"][k].numpy(), err_msg=k)
        for k in ("ts", "alphas", "weights"):
            np.testing.assert_allclose(out_k["samples"][k].detach().cpu().numpy(),
                                       out_p["samples"][k].detach().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nvol", "svox1"])
def test_compat_output_cotangents_match_plain_versions(cuda, mode):
    """K14's compat_backward_out: the cotangents of rgb, depth and alpha /
    log_transmit against autograd of the plain march on the same card."""
    from alphasurf_torch.render import compat as Cm

    a, rays = _basis_inputs(cuda, "texture")
    opt = pt.RenderOptions(step_size=0.5, sigma_thresh=0.1)
    names = ("density_data", "sh_data")
    keys = ("rgb", "depth", "log_transmit") + (("alpha",) if mode == "nvol" else ())
    gen = torch.Generator().manual_seed(1)
    w = {k: torch.rand((64, 3) if k == "rgb" else (64,), generator=gen).to(cuda) - 0.5
         for k in keys}

    def run(g, plain):
        params = [getattr(g, n).requires_grad_(True) for n in names]
        if plain:
            fn = Cm._nvol_plain if mode == "nvol" else Cm._svox1_plain
            o, dd, ds, shm, tmin, tmax = Cm._march_setup(g, rays, mode == "svox1")
            rgb, depth, acc = fn(g, opt, o, dd, ds, shm, tmin, tmax, Cm.max_steps_for(g, opt))
            bgw = (1 - acc) if mode == "nvol" else torch.exp(acc)
            out = {"rgb": rgb + bgw[:, None], "depth": depth, "alpha": acc,
                   "log_transmit": (torch.log(torch.clamp(1 - acc, min=1e-10)) if mode == "nvol"
                                    else acc)}
        else:
            out = Cm.BACKENDS[mode](g, rays, opt)
        return torch.autograd.grad(sum((out[k] * w[k]).sum() for k in keys), params)

    kernels.reset_launches()
    gk = run(SparseGrid.from_numpy(a, device=cuda), False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"compat_backward_out_{mode}"] == 1
    gp = run(SparseGrid.from_numpy(a, device=cuda), True)
    for x, r in zip(gk, gp):
        assert float((x - r).norm()) <= 1e-3 * float(r.norm()) + 1e-7
