"""The port's stage transitions (``alphasurf_torch.core.topology``: K9a keep
masks, K9b resample, and the plain PyTorch around them) against the JAX
package's, on the CPU in float64.

Each case runs the port against the JAX device path (``core.topology_device``,
whose semantics the port has) with links equal and rows to rtol 1e-8, and
against the JAX host path (``core.topology``) with links equal and rows to
the JAX package's own host == device tolerance, atol 2e-5. Grids are the
randomised sparse grids of ``tests/test_topology_device.py`` (float64 here)
and ``make_gt_grid(16)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu import defs
from alphasurf_tpu.core import topology as JT
from alphasurf_tpu.core import topology_device as JD
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_torch.core import topology as T
from alphasurf_torch.core.grid import SparseGrid
from test_torch_util import jax_grid


def rand_grid(seed, reso=(9, 10, 11), surface=True, hole_frac=0.3):
    """numpy arrays of ``test_topology_device._rand_grid``'s grid: random
    holes, density N(1, 1), 12 SH channels, surface N(0, 1), level set 0."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(reso))
    keep = ~(rng.random(n) < hole_frac)
    links = np.full(n, -1, np.int32)
    links[keep] = np.arange(keep.sum(), dtype=np.int32)
    rows = np.arange(n)[keep]
    a = {
        "links": links.reshape(reso),
        "density_data": (rng.standard_normal((n, 1)).astype(np.float32)[rows] + 1.0).astype(
            np.float64),
        "sh_data": rng.standard_normal((n, 12)).astype(np.float32)[rows].astype(np.float64),
        "surface_data": None,
        "level_set_data": None,
        "fake_sample_std": None,
        "truncated_vol_render_a": np.asarray(1.0),
        "radius": np.ones(3),
        "center": np.zeros(3),
        "basis_dim": 4,
        "surface_type": defs.SURFACE_TYPE_NONE,
    }
    if surface:
        a["surface_data"] = rng.standard_normal((n, 1)).astype(np.float32)[rows].astype(np.float64)
        a["level_set_data"] = np.zeros(1)
        a["surface_type"] = defs.SURFACE_TYPE_SDF
    return a


def both(a):
    return jax_grid(a, jnp.float64), SparseGrid.from_numpy(a, device="cpu")


def assert_grids(port, ref, rtol=0.0, atol=0.0, fields=("density_data", "sh_data",
                                                           "surface_data")):
    np.testing.assert_array_equal(port.links.numpy(), np.asarray(ref.links))
    assert port.capacity == ref.capacity
    for f in fields:
        r = getattr(ref, f)
        if r is None:
            assert getattr(port, f) is None, f
            continue
        np.testing.assert_allclose(getattr(port, f).detach().numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=f)


def check_both(port, ref_device, ref_host, **kw):
    assert port.capacity > 0
    assert_grids(port, ref_device, rtol=1e-8, atol=1e-12, **kw)
    assert_grids(port, ref_host, atol=2e-5, **kw)


@pytest.mark.parametrize("kw", [
    dict(sigma_thresh=1.0, dilate=1, max_elements=0),
    dict(sigma_thresh=1.0, dilate=1, max_elements=300),
    dict(sigma_thresh=1e9, dilate=0, last_sample_opaque=True),
])
def test_resample_matches_jax(kw):
    a = rand_grid(3, surface=False)
    gj, gt = both(a)
    port = T.resample(gt, (13, 12, 15), **kw)
    check_both(port, JD.resample_device(gj, (13, 12, 15), **kw),
               JT.resample(gj, (13, 12, 15), **kw))
    if kw.get("last_sample_opaque"):
        assert port.capacity == 13 * 12  # only the z = -1 plane survives


def _lv_band_grid():
    """Alpha only where the surface is strongly positive, so that the alpha
    mask alone loses the crossing shell (test_resample_surface_keep_lv_band)."""
    a = rand_grid(11, hole_frac=0.2)
    a["density_data"] = (a["surface_data"] > 1.0).astype(np.float64)
    return a


@pytest.mark.parametrize("case", [
    ("alpha d0", lambda: rand_grid(5), (14, 13, 16), dict(alpha_thresh=0.8, dilate=0)),
    ("alpha d2", lambda: rand_grid(5), (14, 13, 16), dict(alpha_thresh=0.8, dilate=2)),
    ("alpha d0 max", lambda: rand_grid(5), (14, 13, 16),
     dict(alpha_thresh=0.8, dilate=0, max_elements=500)),
    ("alpha d2 max", lambda: rand_grid(5), (14, 13, 16),
     dict(alpha_thresh=0.8, dilate=2, max_elements=500)),
    ("sigmoid", lambda: rand_grid(6), (12, 12, 12),
     dict(alpha_thresh=0.4, dilate=1, sigmoid_alpha=True)),
    ("non_expanding", lambda: rand_grid(7, hole_frac=0.4), (14, 15, 13),
     dict(alpha_thresh=0.2, dilate=1, non_expanding=True)),
    ("lv band", _lv_band_grid, (14, 15, 13), dict(alpha_thresh=0.5, dilate=0, keep_lv_band=True)),
    ("downscale", lambda: rand_grid(8, hole_frac=0.1), (6, 7, 5), dict(alpha_thresh=0.5, dilate=1)),
], ids=lambda c: c[0])
def test_resample_surface_matches_jax(case):
    _, make, new_reso, kw = case
    gj, gt = both(make())
    port = T.resample_surface(gt, new_reso, **kw)
    check_both(port, JD.resample_surface_device(gj, new_reso, **kw),
               JT.resample_surface(gj, new_reso, **kw))
    if kw.get("keep_lv_band"):  # the band keeps more than the alpha mask alone
        no_band = T.resample_surface(gt, new_reso, **dict(kw, keep_lv_band=False))
        assert port.capacity > no_band.capacity


@pytest.mark.parametrize("prune_surf", [False, True])
def test_prune_grid_matches_jax(prune_surf):
    gj, gt = both(rand_grid(9))
    kw = dict(density_raw_thres=1.0, dilate=1, prune_surf=prune_surf)
    check_both(T.prune_grid(gt, **kw), JD.prune_grid_device(gj, **kw), JT.prune_grid(gj, **kw))


def test_metric_rescale_matches_jax():
    """Level sets float32, as init_surface_from_density leaves them in both
    packages."""
    gj, gt = both(rand_grid(10))
    lv = np.asarray([0.0, -4.0], np.float32)
    gj = gj.replace(level_set_data=jnp.asarray(lv))
    gt.level_set_data = torch.as_tensor(lv)
    port = T._metric_rescale(gt)
    for ref, rtol in ((JD.metric_rescale_device(gj), 1e-8), (JT._metric_rescale(gj), 2e-5)):
        np.testing.assert_allclose(port.surface_data.detach().numpy(),
                                   np.asarray(ref.surface_data), rtol=rtol)
        np.testing.assert_allclose(port.level_set_data.numpy(), np.asarray(ref.level_set_data),
                                   rtol=rtol)
    assert port.level_set_data.dtype == torch.float32


def density_grid():
    """A density grid over make_gt_grid(16)'s lattice: a soft ball of
    density up to 10 around its SDF sphere, with holes."""
    g = jax_make_gt_grid(16, basis_dim=4)
    rng = np.random.default_rng(12)
    s = np.asarray(g.surface_data, np.float64)[:, 0]
    keep = rng.random(s.size) >= 0.1
    links = np.full(s.size, -1, np.int32)
    links[keep] = np.arange(keep.sum(), dtype=np.int32)
    dens = 10.0 / (1.0 + np.exp(-2.0 * s)) + 0.1 * rng.standard_normal(s.size)
    return {
        "links": links.reshape(16, 16, 16), "density_data": dens[keep, None],
        "sh_data": np.asarray(g.sh_data, np.float64)[keep], "surface_data": None,
        "level_set_data": None, "fake_sample_std": None,
        "truncated_vol_render_a": np.asarray(1.0), "radius": np.ones(3), "center": np.zeros(3),
        "basis_dim": 4, "surface_type": defs.SURFACE_TYPE_NONE,
    }


def orbit_cameras(side, n=2):
    """n cameras on a circle of radius 2.7 around the lattice, side x side
    pixels (128: one 16,384-ray chunk of the JAX sweeps, which then pad
    nothing), as (JAX cameras, port cameras)."""
    import alphasurf_tpu as at
    import alphasurf_torch as pt
    from alphasurf_tpu.data.synthetic import pose_spherical

    poses = [pose_spherical(360.0 * i / n + 17.0, 25.0 - 40.0 * i, 2.7) for i in range(n)]
    return ([at.Camera.make(jnp.asarray(p), fx=1.2 * side, width=side, height=side)
             for p in poses],
            [pt.Camera.make(p, fx=1.2 * side, width=side, height=side) for p in poses])


@pytest.mark.parametrize("vis_scale", [0.0, 0.01])
def test_init_surface_from_density_matches_jax(monkeypatch, vis_scale):
    """init_surface_from_density is host code in the JAX package that
    dispatches prune and rescale by size; with the dispatch size at 1 it
    takes the device path (rtol 1e-8), as it is, the host path (atol 2e-5)."""
    a = density_grid()
    gj, gt = both(a)
    cj, ct = orbit_cameras(128)
    kw = dict(density_lvs=[2.0, 6.0], alpha_rescale=0.005, prune_threshold=1.0, dilate=2,
              visibility_pruning_scale=vis_scale)
    port = T.init_surface_from_density(gt, weight_init_cams=ct, **kw)
    host = JT.init_surface_from_density(gj, weight_init_cams=cj, **kw)
    monkeypatch.setattr(JT, "_DEVICE_DISPATCH_SIZE", 1)
    dev = JT.init_surface_from_density(gj, weight_init_cams=cj, **kw)
    check_both(port, dev, host)
    for ref in (dev, host):
        np.testing.assert_array_equal(port.level_set_data.numpy(), np.asarray(ref.level_set_data))
    assert port.surface_type == defs.SURFACE_TYPE_SDF
    if vis_scale > 0:  # visibility pruning moved some surfaces
        plain = T.init_surface_from_density(gt, weight_init_cams=ct,
                                            **dict(kw, visibility_pruning_scale=0.0))
        assert (port.surface_data != plain.surface_data).any()


def _weight_init_kw():
    return dict(density_lvs=[2.0, 6.0], alpha_rescale=0.005, prune_threshold=1.0, dilate=2,
                init_type="weight")


def _float32_sweep(sweep):
    """The JAX package's transmittance march on the grid's density in
    float32: on a float64 grid its float32 scan carry fails, and float32
    is what the port's march reads."""
    def run(grid, cams, **kw):
        return sweep(grid.replace(density_data=grid.density_data.astype(jnp.float32)), cams, **kw)

    return run


def test_unported_init_options_raise(monkeypatch):
    """Mask pruning (K9f) raises. The weight init (K9e), ported, equals the
    JAX host path's with the JAX march run in float32: the maxima of the
    two float32 marches differ in the last bit (test_torch_weight_render),
    so the links agree exactly and the rows to 2e-6 relative, or 1e-6
    absolute where the surface, density x weight minus the zero level,
    cancels."""
    from alphasurf_tpu.core import weight_render as JW

    gj, gt = both(density_grid())
    with pytest.raises(NotImplementedError, match="K9f"):
        T.init_surface_from_density(gt, mask_pruning_rays=object())
    with pytest.raises(ValueError, match="requires cameras"):
        T.init_surface_from_density(gt, init_type="weight")
    monkeypatch.setattr(JW, "sparse_grid_weight_render", _float32_sweep(
        JW.sparse_grid_weight_render))
    cj, ct = orbit_cameras(32, 4)
    port = T.init_surface_from_density(gt, weight_init_cams=ct, **_weight_init_kw())
    assert_grids(port, JT.init_surface_from_density(gj, weight_init_cams=cj, **_weight_init_kw()),
                 rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("vis_scale", [0.0, 0.01])
def test_init_surface_weight_matches_jax(monkeypatch, vis_scale):
    """init_surface_from_density(init_type="weight") against the JAX device
    path (dispatch size 1), float64, rtol 1e-8, with the JAX package's march
    handed the port's maxima (their float32 rounding is held against JAX's
    in test_torch_weight_render); the host path to atol 2e-5. The weight
    init moves the surface: it differs from the density init's."""
    from alphasurf_tpu.core import weight_render as JW
    from alphasurf_torch.core import weight_render as W

    gj, gt = both(density_grid())
    cj, ct = orbit_cameras(32, 4)
    kw = dict(_weight_init_kw(), visibility_pruning_scale=vis_scale)
    wt = W.sparse_grid_weight_render(gt, ct)
    assert 0 < float(wt.max()) <= 1.0
    monkeypatch.setattr(JW, "sparse_grid_weight_render", lambda grid, cams: jnp.asarray(wt.numpy()))
    port = T.init_surface_from_density(gt, weight_init_cams=ct, **kw)
    host = JT.init_surface_from_density(gj, weight_init_cams=cj, **kw)
    monkeypatch.setattr(JT, "_DEVICE_DISPATCH_SIZE", 1)
    check_both(port, JT.init_surface_from_density(gj, weight_init_cams=cj, **kw), host)
    dens_init = T.init_surface_from_density(gt, weight_init_cams=ct,
                                            **dict(kw, init_type="density"))
    assert (dens_init.links == port.links).all()
    assert (dens_init.surface_data != port.surface_data).any()


@pytest.mark.parametrize("size,k,thresh", [
    (1000, 100, 0.0), (1000, 100, 5.0), (5_000_000, 60_000, 0.0), (5_000_000, 6_000, -1.0),
])
def test_kth_largest_thresh_matches_jax(size, k, thresh):
    """The sort path (<= 2^22 elements) and the two-pass histogram path."""
    rng = np.random.default_rng(size + k)
    x = (rng.standard_normal(size) ** 3).astype(np.float32)
    got = T._kth_largest_thresh(torch.as_tensor(x), k, thresh)
    assert got == JD._kth_largest_thresh(jnp.asarray(x), k, thresh)
    assert int((x >= np.float32(got)).sum()) <= k or got == thresh


def test_upsample_dispatches_like_jax():
    a = rand_grid(13)
    gj, gt = both(a)
    assert_grids(T.upsample(gt, 12, alpha_upsample_thresh=0.5),
                 JD.resample_surface_device(gj, (12, 12, 12), alpha_thresh=0.5), rtol=1e-8)
    a = rand_grid(13, surface=False)
    gj, gt = both(a)
    assert_grids(T.upsample(gt, 12, alpha_upsample_thresh=0.5),
                 JD.resample_device(gj, (12, 12, 12), sigma_thresh=0.5), rtol=1e-8)
