"""The port's cuvol (Plenoxels) renderer against the JAX package's: grid
creation, the density occupancy, the packed renderer's outputs and
gradients, and the dense march, in float64 on the CPU (float32 where
stated)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.render import cuvol as JC
from alphasurf_tpu.render.image import render_image as jax_render_image
from alphasurf_torch.core.grid import SparseGrid, create_grid
from alphasurf_torch.render import cuvol as TC
from alphasurf_torch.render.image import render_image, volume_render_depth
from test_torch_util import BASE, jax_grid, jax_to_np, np_grid, np_rays, t64

# parametrised over last_sample_opaque, use_spheric_clip, near_clip and
# depth_sigma_thresh; the keys are RenderOptions fields plus "dst"
PACKED_SETS = [
    dict(near_clip=0.05),
    dict(near_clip=0.05, last_sample_opaque=True, dst=0.5),
    dict(use_spheric_clip=True),
    dict(use_spheric_clip=True, last_sample_opaque=True, near_clip=0.2),
    dict(near_clip=0.0, step_size=0.3, dst=1.5),
    dict(near_clip=0.3, dst=0.5),
]
B = 32


def _opts(kw):
    kw = dict(kw)
    dst = kw.pop("dst", None)
    return at.RenderOptions(**kw), pt.RenderOptions(**kw), dst


def _per_ray_jax(kw) -> bool:
    """With the sphere clip and last_sample_opaque, a ray's last sample has
    log_att ~ -1e9 sigma inside the sphere, and the JAX renderer's
    chunk-wide cumsum minus a per-ray base (cuvol.py:245-251) cancels at
    ulp(1e9) ~ 1.2e-7 for every later ray. That set is rendered one ray per
    JAX call, where the base is 0."""
    return kw.get("use_spheric_clip", False) and kw.get("last_sample_opaque", False)


@functools.lru_cache(maxsize=None)
def _blobby(reso=14, seed=0, basis_dim=4, sphere_bound=False):
    """A float64 JAX grid with a blobby shell of density (negative in
    places) and random SH, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    g = jax_create_grid(reso, basis_dim=basis_dim, init_sigma=0.0, use_sphere_bound=sphere_bound,
                        dtype=jnp.float64)
    links = np.asarray(g.links).reshape(-1)
    coords = np.stack(np.meshgrid(*[np.arange(reso)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = np.linalg.norm(coords - reso / 2.0, axis=-1)
    dens = np.maximum(0.0, 3.0 - np.abs(r - reso / 4.0)) * 2.0 + rng.standard_normal(r.shape) * 0.3
    gj = g.replace(density_data=jnp.asarray(dens[links >= 0, None]),
                   sh_data=jnp.asarray(rng.standard_normal((g.capacity, 3 * basis_dim)) * 0.3))
    return gj, jax_to_np(gj)


def _port_grid(a, dtype=torch.float64):
    return SparseGrid.from_numpy(a, device="cpu", dtype=dtype)


@functools.lru_cache(maxsize=None)
def _rays():
    return np_rays(B, seed=4)


# ---------------------------------------------------------------------------
# grid and occupancy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(reso=8),
    dict(reso=9, use_sphere_bound=True, init_sigma=0.3, init_rgb=0.2),
    dict(reso=(12, 10, 11), use_sphere_bound=True, radius=(1.0, 1.5, 0.75),
         center=(0.1, -0.2, 0.3), trainable_fake_sample_std=True, basis_dim=4),
])
def test_create_grid_matches_jax(kw):
    ref = jax_to_np(jax_create_grid(**kw, dtype=jnp.float64))
    got = create_grid(**kw, dtype=torch.float64, device="cpu").to_numpy()
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    g32 = create_grid(**kw, device="cpu")
    assert g32.dtype == torch.float32 and g32.capacity == ref["sh_data"].shape[0]


def test_create_grid_surface_initialisers_raise():
    """The surface initialisers are ported (their parity over every type and
    initialiser is tests/test_torch_types.py's): create_grid(8, SDF) equals
    JAX's. What still raises is what raises in JAX: the cuvol renderers on
    UDF_ALPHA's per-level-set density table (a TypeError, as JAX's
    concatenation of the rows), whose density occupancy both packages take
    at the clipped row."""
    gj = at.create_grid(8, surface_type=at.defs.SURFACE_TYPE_SDF)
    g = create_grid(8, surface_type=pt.defs.SURFACE_TYPE_SDF, device="cpu")
    for k in ("links", "density_data", "sh_data", "surface_data", "level_set_data"):
        np.testing.assert_array_equal(getattr(g, k).detach().numpy(), np.asarray(getattr(gj, k)))
    gj = at.create_grid(8, surface_type=at.defs.SURFACE_TYPE_UDF_ALPHA, surface_init="single_lv")
    g = create_grid(8, surface_type=pt.defs.SURFACE_TYPE_UDF_ALPHA, surface_init="single_lv",
                    device="cpu")
    np.testing.assert_array_equal(TC.density_occupancy(g).numpy(),
                                  np.asarray(JC.density_occupancy(gj)))
    rays = pt.Rays(torch.tensor([[0.0, 0.0, -2.5]]), torch.tensor([[0.0, 0.0, 1.0]]))
    for fn in (TC.volume_render_cuvol_packed, TC.volume_render_cuvol):
        with pytest.raises(TypeError):
            fn(g, rays, pt.RenderOptions())


@pytest.mark.parametrize("sphere_bound", [False, True])
def test_density_occupancy_matches_jax(sphere_bound):
    gj, a = _blobby(sphere_bound=sphere_bound)
    g = _port_grid(a)
    np.testing.assert_array_equal(TC.density_occupancy(g).numpy(),
                                  np.asarray(JC.density_occupancy(gj)))
    np.testing.assert_array_equal(TC.density_occupancy(_port_grid(a, torch.float32)).numpy(),
                                  np.asarray(JC.density_occupancy(gj)))


# ---------------------------------------------------------------------------
# the packed renderer (K8's plain path)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_packed_fn(opt, dst):
    # compiled whole, for a chunk or one ray: an eager first call compiles
    # every primitive anew (~40 s on the CPU)
    return jax.jit(lambda g, o, d: JC.volume_render_cuvol_packed(
        g, at.Rays(o, d), opt, entries_per_ray=64.0, depth_sigma_thresh=dst))


def _jax_packed(gj, o, d, opt, dst, per_ray: bool) -> dict:
    f = _jax_packed_fn(opt, dst)
    if not per_ray:
        return f(gj, jnp.asarray(o), jnp.asarray(d))
    outs = [f(gj, jnp.asarray(o[i:i + 1]), jnp.asarray(d[i:i + 1])) for i in range(o.shape[0])]
    return {k: np.concatenate([np.atleast_1d(np.asarray(x[k])) for x in outs]) for k in outs[0]}


@pytest.mark.parametrize("kw", PACKED_SETS)
def test_packed_matches_jax(kw):
    gj, a = _blobby()
    o, d = _rays()
    opt_j, opt_t, dst = _opts(kw)
    ref = _jax_packed(gj, o, d, opt_j, dst, _per_ray_jax(kw))
    got = TC.volume_render_cuvol_packed(_port_grid(a), pt.Rays(t64(o), t64(d)), opt_t,
                                        depth_sigma_thresh=dst)
    keys = ["rgb", "depth", "log_transmit"] + (["depth_sigma_thresh"] if dst is not None else [])
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(got["n_occupied"].numpy(), np.asarray(ref["n_occupied"]))
    assert int(np.sum(ref["pool_overflow"])) == 0 and got["pool_overflow"] == 0
    assert float(got["rgb"].std()) > 0.01 and float(got["log_transmit"].min()) < -1.0


@pytest.mark.parametrize("kw", PACKED_SETS)
def test_packed_gradients_match_jax(kw):
    """d sum(rgb * cot) / d density, SH: autograd of the port's plain path
    against jax.grad, to rtol 1e-8 (atol 1e-8 of the largest entry)."""
    gj, a = _blobby()
    o, d = _rays()
    opt_j, opt_t, dst = _opts(kw)
    cot = np.random.default_rng(7).standard_normal((B, 3))

    def loss_j(dens, sh, o, d, c):
        out = JC.volume_render_cuvol_packed(gj.replace(density_data=dens, sh_data=sh),
                                            at.Rays(o, d), opt_j, entries_per_ray=64.0)
        return jnp.sum(out["rgb"] * c)

    if _per_ray_jax(kw):
        f = jax.jit(jax.grad(loss_j, argnums=(0, 1)))
        parts = [f(gj.density_data, gj.sh_data, jnp.asarray(o[i:i + 1]), jnp.asarray(d[i:i + 1]),
                   jnp.asarray(cot[i:i + 1])) for i in range(B)]
        ref = [sum(np.asarray(p[j]) for p in parts) for j in range(2)]
    else:
        ref = [np.asarray(x) for x in jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
            gj.density_data, gj.sh_data, jnp.asarray(o), jnp.asarray(d), jnp.asarray(cot))]
    g = _port_grid(a)
    params = [g.density_data.requires_grad_(True), g.sh_data.requires_grad_(True)]
    out = TC.volume_render_cuvol_packed(g, pt.Rays(t64(o), t64(d)), opt_t, depth_sigma_thresh=dst)
    got = torch.autograd.grad((out["rgb"] * t64(cot)).sum(), params)
    for name, x, r in zip(("density", "sh"), got, ref):
        assert np.abs(r).max() > 1e-3, name
        np.testing.assert_allclose(x.numpy(), r, rtol=1e-8, atol=1e-8 * np.abs(r).max(),
                                   err_msg=name)


def test_packed_float32_matches_jax_on_small_chunks():
    """float32, both packages: the JAX renderer on 8-ray chunks (its
    chunk-wide prefix cancels in float32 as the chunk grows, ROADMAP §3)."""
    gj, a = _blobby()
    gj32 = jax_create_grid(14, basis_dim=4, init_sigma=0.0).replace(
        density_data=jnp.asarray(a["density_data"], jnp.float32),
        sh_data=jnp.asarray(a["sh_data"], jnp.float32))
    o, d = (x.astype(np.float32) for x in _rays())
    opt_j, opt_t, _ = _opts(PACKED_SETS[0])
    f = _jax_packed_fn(opt_j, None)
    outs = [f(gj32, jnp.asarray(o[i:i + 8]), jnp.asarray(d[i:i + 8])) for i in range(0, B, 8)]
    ref = {k: np.concatenate([np.asarray(x[k]) for x in outs]) for k in ("rgb", "log_transmit")}
    got = TC.volume_render_cuvol_packed(_port_grid(a, torch.float32),
                                        pt.Rays(torch.as_tensor(o), torch.as_tensor(d)), opt_t)
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["log_transmit"].numpy(), ref["log_transmit"], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the dense march (K10's plain path), image and depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lso", [False, True])
@pytest.mark.parametrize("dst", [None, 0.5])
def test_dense_march_matches_jax(dst, lso):
    gj, a = _blobby(sphere_bound=True)
    o, d = _rays()
    kw = dict(near_clip=0.05, last_sample_opaque=lso)
    ref = JC.volume_render_cuvol(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                 at.RenderOptions(**kw), depth_sigma_thresh=dst)
    got = TC.volume_render_cuvol(_port_grid(a), pt.Rays(t64(o), t64(d)), pt.RenderOptions(**kw),
                                 depth_sigma_thresh=dst)
    for k in ("rgb", "depth", "log_transmit") + (("depth_sigma_thresh",) if dst else ()):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)


def _boundary_camera(n=24):
    """A camera on the +x axis looking at the centre: its central rays leave
    through the face-centre vertices of the lattice's outer shell, where
    |p| = 1 and create_grid's sphere-bound mask keeps the links."""
    from alphasurf_torch.data.synthetic import pose_spherical

    return pose_spherical(0.0, 0.0, 2.5), dict(fx=0.9 * n, width=n, height=n)


def test_render_image_matches_jax_on_a_sphere_bounded_grid():
    """render_image of a cuvol grid (the Trainer's eval path) equals the JAX
    package's, including the face-centre boundary rays, which the packed
    renderer would drop (its documented outer half-voxel band)."""
    reso = 10
    rng = np.random.default_rng(3)
    gj = jax_create_grid(reso, basis_dim=4, use_sphere_bound=True, dtype=jnp.float64)
    gj = gj.replace(density_data=jnp.asarray(rng.uniform(0.0, 3.0, (gj.capacity, 1))),
                    sh_data=jnp.asarray(rng.standard_normal((gj.capacity, 12)) * 0.3))
    g = _port_grid(jax_to_np(gj))
    c2w, cam_kw = _boundary_camera()
    opt = dict(near_clip=0.0)
    ref_img, ref_depth = jax_render_image(gj, at.Camera.make(jnp.asarray(c2w), **cam_kw),
                                          at.RenderOptions(**opt), return_depth=True)
    cam = pt.Camera.make(c2w, **cam_kw)
    img, depth = render_image(g, cam, pt.RenderOptions(**opt), return_depth=True, device="cpu")
    np.testing.assert_allclose(img, ref_img, rtol=0, atol=1e-6)
    np.testing.assert_allclose(depth, ref_depth, rtol=1e-6, atol=1e-5)
    rays = cam.gen_rays_device("cpu")
    rays = pt.Rays(rays.origins.double(), rays.dirs.double())
    packed = TC.volume_render_cuvol_packed(g, rays, pt.RenderOptions(**opt))["rgb"].numpy()
    assert np.abs(packed - img.reshape(-1, 3)).max() > 1e-3  # the band the packed path drops


def test_volume_render_depth_matches_jax():
    from alphasurf_tpu.render.image import volume_render_depth as jax_depth

    gj, a = _blobby(sphere_bound=True)
    o, d = _rays()
    g = _port_grid(a)
    for kw in (dict(sigma_thresh=None), dict(sigma_thresh=0.7)):
        ref = jax_depth(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(), **kw)
        got = volume_render_depth(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)
    with pytest.raises(NotImplementedError):
        volume_render_depth(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(), depth_type="mode")
    # a surface grid: with a threshold, the sigma-thresh depth of the packed
    # renderer (its mean depth differs on some of these rays)
    a = np_grid(16, seed=3, prune=0.2)
    o, d = np_rays(64, seed=4)
    opt_kw = dict(BASE)
    ref = jax.jit(lambda gj_, o_, d_: jax_depth(gj_, at.Rays(o_, d_), at.RenderOptions(**opt_kw),
                                                sigma_thresh=0.5))(
        jax_grid(a), jnp.asarray(o), jnp.asarray(d))
    g = SparseGrid.from_numpy(a, device="cpu")
    got = volume_render_depth(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw),
                              sigma_thresh=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)
    mean = volume_render_depth(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw))
    assert np.abs(mean.numpy() - np.asarray(ref)).max() > 1.0
