"""The K-slot compact surface renderer (K11b's path) and the first-K sample
cache of the packed renderer (K11c) against the JAX package's
``volume_render_surface_compact`` and ``volume_render_surface_packed``, in
float64 on the CPU: every output key, with K covering every crossing and
truncating, stop_thresh off and killing rays mid-walk; their gradients
against jax.grad, cache losses included; and the compact renderer equal to
the packed one while K covers every crossing."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import surface as TS
from test_torch_dense import grads_match_jax
from test_torch_util import (
    BASE, OPTION_SETS, STOP_SETS, assert_outputs_match, dense_grid, jax_grid, np_grid, np_rays,
    t64,
)


def _inputs(kw):
    a = dense_grid() if kw in STOP_SETS else np_grid(12, seed=3, prune=0.2)
    o, d = np_rays(48, seed=4)
    return (jax_grid(a), SparseGrid.from_numpy(a, device="cpu"),
            at.Rays(jnp.asarray(o), jnp.asarray(d)), pt.Rays(t64(o), t64(d)),
            at.RenderOptions(**{**BASE, **kw}), pt.RenderOptions(**{**BASE, **kw}))


@pytest.mark.parametrize("kw", [OPTION_SETS[1], OPTION_SETS[4]] + STOP_SETS)
def test_compact_matches_jax_float64(kw):
    """K = 64 covers every ray's crossings, K = 2 truncates; voxel_chunk 8
    and 1 set how the JAX renderer counts samples past a stop_thresh kill."""
    gj, gt, rj, rt, oj, ot = _inputs(kw)
    for K, V, cache_size in ((64, 8, None), (64, 8, 5), (2, 1, 64), (2, 8, None)):
        ref = JS.volume_render_surface_compact(gj, rj, oj, max_intersect_voxels=K, voxel_chunk=V,
                                               cache_size=cache_size)
        got = TS.volume_render_surface_compact(gt, rt, ot, max_intersect_voxels=K, voxel_chunk=V,
                                               cache_size=cache_size)
        assert set(got) == set(ref)
        assert_outputs_match(got, ref)
    n_occ = np.asarray(ref["n_occupied"])
    assert n_occ.max() > 2 and np.asarray(ref["n_intersections"]).sum() > 0  # K = 2 truncates


@pytest.mark.parametrize("kw", [OPTION_SETS[2]] + STOP_SETS)
def test_packed_cache_matches_jax_float64(kw):
    """The packed renderer's cache (alpha_c, its own count) and its
    cache-free depth_med, with a cache holding every sample and a
    truncating one. The JAX side renders one ray a call: its median takes
    per-ray prefixes as a chunk-wide cumsum minus a per-ray base (ROADMAP
    §3), which here cancels to ~5e-15 where two clipped weights of 1e-7 tie
    the half-weight test within 5e-15."""
    gj, gt, rj, rt, oj, ot = _inputs(kw)
    for cache_size in (64, 3):
        render = jax.jit(functools.partial(JS.volume_render_surface_packed, opt=oj,
                                           entries_per_ray=48, cache_size=cache_size))
        outs = [render(gj, at.Rays(rj.origins[i:i + 1], rj.dirs[i:i + 1]))
                for i in range(rj.origins.shape[0])]
        ref = jax.tree_util.tree_map(lambda *x: np.concatenate([np.atleast_1d(v) for v in x]),
                                     *[{k: v for k, v in o.items()
                                        if k not in ("n_entries_used", "pool_overflow")}
                                       for o in outs])
        assert sum(int(o["pool_overflow"]) for o in outs) == 0
        got = TS.volume_render_surface_packed(gt, rt, ot, cache_size=cache_size)
        assert got["pool_overflow"] == 0
        assert_outputs_match(got, ref, skip=("n_entries_used", "pool_overflow"))
    assert np.asarray(ref["cache"]["fake_mask"]).any() or not ot.surf_fake_sample


@pytest.mark.parametrize("kw", [OPTION_SETS[4], STOP_SETS[1]])
def test_compact_gradients_match_jax(kw):
    a = dense_grid() if kw in STOP_SETS else np_grid(12, seed=3, prune=0.1)
    grads_match_jax(
        a, functools.partial(JS.volume_render_surface_compact, max_intersect_voxels=3,
                             voxel_chunk=2, cache_size=6),
        functools.partial(TS.volume_render_surface_compact, max_intersect_voxels=3,
                          voxel_chunk=2, cache_size=6), {**BASE, **kw})


def test_packed_cache_gradients_match_jax():
    grads_match_jax(np_grid(12, seed=3, prune=0.1),
                    functools.partial(JS.volume_render_surface_packed, entries_per_ray=48,
                                      cache_size=6),
                    functools.partial(TS.volume_render_surface_packed, cache_size=6),
                    {**BASE, **OPTION_SETS[4]})


@pytest.mark.parametrize("kw", OPTION_SETS)
def test_compact_equals_packed_and_dense_while_k_covers(kw):
    """float64, the port alone: with K above every ray's occupied count the
    three renderers give the same rgb, depth, normal and transmittance."""
    _, gt, _, rt, _, ot = _inputs(kw)
    comp = TS.volume_render_surface_compact(gt, rt, ot, max_intersect_voxels=64)
    assert int(comp["n_occupied"].max()) < 64
    for other in (TS.volume_render_surface_packed(gt, rt, ot), TS.volume_render_surface(gt, rt, ot)):
        for k in ("rgb", "depth", "normal", "log_transmit"):
            np.testing.assert_allclose(comp[k].numpy(), other[k].numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=k)
    assert torch.equal(comp["n_occupied"].long(),
                       (TS.volume_render_surface_compact(gt, rt, ot, max_intersect_voxels=1)
                        ["n_occupied"]).long())


def test_float32_compact_differs_from_jax_only_in_unseen_counts():
    """float32 on device-made rays of a 48x48 view of make_gt_grid(16)
    and the near-axis corner camera: JAX's compact_crossings sorts float32
    plane crossings (all_crossings), where near a voxel corner two
    crossings a few ulp apart leave a sliver or skip a diagonal voxel; K11b
    takes K2's exact crossings. The renders agree on every ray (rgb to
    1e-5, depth to 1e-5 of its largest value), and n_occupied differs on
    a few rays only: 8 of these 2,368, all of the axis-aligned view (12 of
    9,280 over four views and the corner camera, ROADMAP §3)."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical
    from test_torch_util import corner_camera_rays, jax_to_np

    gj = make_gt_grid(16, basis_dim=9)
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    kw = dict(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    rays = [corner_camera_rays(8)]
    cam = at.Camera.make(jnp.asarray(pose_spherical(0.0, 0.0, 2.5)), fx=58.0, width=48, height=48)
    r = cam.gen_rays_device()
    rays.append((np.array(r.origins), np.array(r.dirs)))
    n_rays = n_diff = 0
    for o, d in rays:
        o, d = o.astype(np.float32), d.astype(np.float32)
        ref = JS.volume_render_surface_compact(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                               at.RenderOptions(**kw))
        got = TS.volume_render_surface_compact(gt, pt.Rays(torch.as_tensor(o), torch.as_tensor(d)),
                                               pt.RenderOptions(**kw))
        np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), rtol=0, atol=1e-5)
        dep = np.asarray(ref["depth"])
        np.testing.assert_allclose(got["depth"].numpy(), dep, rtol=0, atol=1e-5 * dep.max())
        n_diff += int((got["n_occupied"].numpy() != np.asarray(ref["n_occupied"])).sum())
        n_rays += o.shape[0]
    assert n_rays == 2368 and n_diff <= 8
