"""The dense DDA surface walk (K11a's path) against the JAX package's
``volume_render_surface``: the walk's DDA steps in float32 and float64,
every output key in float64 (with and without the first-K cache, with
stop_thresh off and killing rays mid-walk), and its gradients against
jax.grad, cache losses included."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import render_losses as JL
from alphasurf_tpu.ops import dda as jdda
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import render_losses as TL
from alphasurf_torch.ops import dda as tdda
from alphasurf_torch.render import surface as TS
from test_torch_util import (
    BASE, OPTION_SETS, STOP_SETS, assert_outputs_match, corner_camera_rays, dense_grid, jax_grid,
    jax_to_np, np_grid, np_rays, t64,
)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_next_crossing_and_voxel_between_match_jax(dtype):
    """Bit for bit, on rays whose t sit on planes (band cases) and off them."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 14, (256, 3)).astype(dtype)
    d = rng.standard_normal((256, 3)).astype(dtype)
    d[:16, 0] = 0.0  # axis-parallel rays
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(dtype)
    t = rng.uniform(0, 8, 256).astype(dtype)
    t[16:48] = ((np.round(o[16:48, 1] + 2) - o[16:48, 1]) / d[16:48, 1]).astype(dtype)  # on planes
    got = tdda.next_crossing(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t))
    ref = jdda.next_crossing(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    t1 = got.numpy()
    t1 = np.where(np.isfinite(t1), t1, t + 1).astype(dtype)
    lg, ig = tdda.voxel_between(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t),
                                torch.as_tensor(t1), (12, 12, 12))
    lr, ir = jdda.voxel_between(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(t1),
                                (12, 12, 12))
    np.testing.assert_array_equal(lg.numpy(), np.asarray(lr))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(ir))


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_walk(origins, dirs, tnear, tmax, ray_ok, reso, max_voxels):
    """The voxels of the JAX package's dense walk: the step of
    render/surface.py:1116-1135 without the compositing, jitted as the
    renderer's scan is."""
    def step(carry, _):
        t, alive = carry
        nt = jdda.next_crossing(origins, dirs, t)
        has = jnp.isfinite(nt)
        seg = alive & has & (t < tmax - 1e-9)
        nts = jnp.where(has, nt, t + 1.0)
        l, inb = jdda.voxel_between(origins, dirs, jnp.where(seg, t, 0.0), jnp.where(seg, nts, 1.0),
                                    reso)
        alive = alive & (nts < tmax + 1e-6) & has
        return (jnp.where(seg, nts, t), alive), (l, seg & inb)

    _, (ls, ok) = jax.lax.scan(step, (jnp.where(ray_ok, tnear, 0.0), ray_ok), None,
                               length=max_voxels)
    return ls, ok


def test_float32_walk_visits_the_same_voxels_as_jax():
    """float32, on device-made rays of two 48x48 views of make_gt_grid(16)
    and on the near-axis camera whose rays cross voxel corners: every
    in-bounds voxel of every ray's walk, in walk order, equals JAX's (0 of
    4,672 rays differ; the on-plane band scales with |pos|, so no walk
    stalls). With every voxel marked occupied, the port's walk lists all of
    them. Rendered, the float32 walk equals the float32 packed renderer on
    every ray."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical

    gj = make_gt_grid(16, basis_dim=9)
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    mv = JS.max_voxels_for(gj)
    rays = []
    for pose in [(30.0, 20.0, 2.7), (0.0, 0.0, 2.5)]:
        cam = at.Camera.make(jnp.asarray(pose_spherical(*pose)), fx=58.0, width=48, height=48)
        r = cam.gen_rays_device()
        rays.append((np.array(r.origins), np.array(r.dirs)))
    o, d = corner_camera_rays(8)
    rays.append((o.astype(np.float32), d.astype(np.float32)))
    n_rays = n_diff = 0
    all_words = torch.full((15, 15, 1), -1, dtype=torch.int32)
    opt = pt.RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    for o, d in rays:
        oj, dj, _, tnj, txj, _, okj, _ = JS._prep(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                                   at.RenderOptions())
        ls, ok = (np.asarray(x) for x in _jax_walk(oj, dj, tnj, txj, okj, gj.reso, mv))
        ot, dt, _, tnt, txt, _, okt, _ = TS._prep(gt, pt.Rays(torch.as_tensor(o), torch.as_tensor(d)),
                                                   pt.RenderOptions())
        pool, _ = TS._dense_walk_plain(gt.reso, ot, dt, tnt, txt, okt, all_words, mv)
        for b in range(o.shape[0]):
            n_diff += not np.array_equal(pool.l[pool.offsets[b]:pool.offsets[b + 1]].numpy(),
                                         ls[ok[:, b], b])
        n_rays += o.shape[0]
        r = pt.Rays(torch.as_tensor(o), torch.as_tensor(d))
        dense, packed = TS.volume_render_surface(gt, r, opt), TS.volume_render_surface_packed(gt, r, opt)
        np.testing.assert_allclose(dense["rgb"].numpy(), packed["rgb"].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(dense["n_intersections"].numpy(),
                                      packed["n_intersections"].numpy())
    assert n_rays == 4672 and n_diff == 0


@pytest.mark.parametrize("kw", [OPTION_SETS[1], OPTION_SETS[4]] + STOP_SETS)
def test_dense_matches_jax_float64(kw):
    """Every output key, with no cache, a cache holding every sample (64)
    and a truncating one (4); the stop sets kill rays mid-walk, where the
    walk counts samples per voxel."""
    a = dense_grid() if kw in STOP_SETS else np_grid(12, seed=3, prune=0.2)
    gj, gt = jax_grid(a), SparseGrid.from_numpy(a, device="cpu")
    o, d = np_rays(48, seed=4)
    rj, rt = at.Rays(jnp.asarray(o), jnp.asarray(d)), pt.Rays(t64(o), t64(d))
    oj, ot = at.RenderOptions(**{**BASE, **kw}), pt.RenderOptions(**{**BASE, **kw})
    for cache_size in (None, 64, 4):
        ref = JS.volume_render_surface(gj, rj, oj, cache_size=cache_size)
        got = TS.volume_render_surface(gt, rt, ot, cache_size=cache_size)
        assert set(got) == set(ref)
        assert_outputs_match(got, ref)
    assert np.asarray(ref["n_intersections"]).sum() > 0
    n_cached = np.asarray(ref["cache"]["n_cached"])
    assert n_cached.max() <= 4 and (n_cached.max() == 4 or kw in STOP_SETS)


def _loss_terms(out, rgb_gt, lib, cache_w=(0.1, 0.3)):
    mean, tsum = (jnp.mean, jnp.sum) if lib is JL else (torch.mean, torch.sum)
    loss = mean((out["rgb"] - rgb_gt) ** 2)
    for k, w in (("l_dist", 1e-2), ("l_dist_a", 1e-2), ("l_entropy", 1e-2), ("l_entropy_a", 1e-2),
                 ("sp_logsig", 1e-3), ("sp_logsig_w", 1e-3), ("l_inward", 1e-2),
                 ("lap_sum", 1e-2)):
        loss = loss + w * tsum(out["ray_losses"][k])
    c = out["cache"]
    loss = loss + cache_w[0] * lib.l_conv_mode_samp_from_cache(c)
    loss = loss + cache_w[1] * lib.l_samp_dist_from_cache(c)
    return loss + 0.05 * tsum(c["alphas"] ** 2) + 0.07 * tsum(c["weights"] * c["ts"])


FIELDS = ("density_data", "surface_data", "sh_data", "fake_sample_std")


def grads_match_jax(a, render_j, render_t, kw, n_rays=32):
    """The gradient of rgb, ray-loss and cache terms with respect to the
    four trained fields, port (autograd of the plain path) against
    jax.grad, float64 rtol 1e-7."""
    o, d = np_rays(n_rays, seed=4)
    gt_rgb = np.random.default_rng(5).uniform(0, 1, (n_rays, 3))

    def jloss(*fields):
        g = jax_grid(a).replace(**dict(zip(FIELDS, fields)))
        out = render_j(g, at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(**kw))
        return _loss_terms(out, gt_rgb, JL)

    value_and_grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))
    lj, gj = value_and_grad(*(jnp.asarray(a[f]) for f in FIELDS))
    g = SparseGrid.from_numpy(a, device="cpu")
    ps = [getattr(g, f).requires_grad_(True) for f in FIELDS]
    out = render_t(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**kw))
    lt = _loss_terms(out, t64(gt_rgb), TL)
    gt = torch.autograd.grad(lt, ps, allow_unused=True)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    for f, x, y in zip(FIELDS, gt, gj):
        x = np.zeros_like(np.asarray(y)) if x is None else x.numpy()
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-7, atol=1e-12, err_msg=f)
    assert np.abs(np.asarray(gj[1])).max() > 0  # the surface moves through the roots


@pytest.mark.parametrize("kw", [OPTION_SETS[4], STOP_SETS[1]])
def test_dense_gradients_match_jax(kw):
    a = dense_grid() if kw in STOP_SETS else np_grid(12, seed=3, prune=0.1)
    grads_match_jax(a, functools.partial(JS.volume_render_surface, cache_size=6),
                    functools.partial(TS.volume_render_surface, cache_size=6), {**BASE, **kw})


def test_max_voxels_cuts_the_walk_like_jax():
    a = np_grid(12, seed=3, prune=0.2)
    o, d = np_rays(32, seed=4)
    opt = dict(BASE)
    ref = JS.volume_render_surface(jax_grid(a), at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                   at.RenderOptions(**opt), max_voxels=9)
    got = TS.volume_render_surface(SparseGrid.from_numpy(a, device="cpu"), pt.Rays(t64(o), t64(d)),
                                   pt.RenderOptions(**opt), max_voxels=9)
    assert_outputs_match(got, ref)
    full = TS.volume_render_surface(SparseGrid.from_numpy(a, device="cpu"), pt.Rays(t64(o), t64(d)),
                                    pt.RenderOptions(**opt))
    assert (full["n_intersections"] > got["n_intersections"]).any()
