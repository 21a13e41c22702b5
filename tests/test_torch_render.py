"""The slice end to end: the port's ``volume_render_surface_packed`` and
``render_image`` against the JAX package's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render.image import render_image as j_render_image
from alphasurf_tpu.render.surface import volume_render_surface_packed as j_render
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render.surface import volume_render_surface_packed as t_render
from test_torch_util import BASE, OPTION_SETS, jax_grid, jax_to_np, np_grid, np_rays, t64


@pytest.mark.parametrize("kw", OPTION_SETS)
def test_packed_render_matches_jax(kw):
    a = np_grid(16, seed=3, prune=0.2)
    gj, gt = jax_grid(a), SparseGrid.from_numpy(a, device="cpu")
    o, d = np_rays(64, seed=4)
    # compiled whole: an eager call's first use in a process compiles every
    # primitive anew (~40 s on the CPU), jax.jit the program (~7 s); float64
    # results agree with the eager call's to ~1e-14 relative
    render = jax.jit(functools.partial(j_render, opt=at.RenderOptions(**{**BASE, **kw}),
                                       entries_per_ray=48))
    ref = render(gj, at.Rays(jnp.asarray(o), jnp.asarray(d)))
    assert int(ref["pool_overflow"]) == 0
    got = t_render(gt, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**{**BASE, **kw}))
    for k in ("rgb", "depth", "normal", "log_transmit", "alpha", "depth_mode", "depth_med"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-9, atol=1e-10,
                                   err_msg=k)
    for k in ("n_intersections", "n_occupied"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["n_entries_used"] == int(ref["n_entries_used"]) and got["pool_overflow"] == 0
    assert set(got["ray_losses"]) == set(ref["ray_losses"])
    for k in ref["ray_losses"]:
        np.testing.assert_allclose(got["ray_losses"][k].numpy(), np.asarray(ref["ray_losses"][k]),
                                   rtol=1e-8, atol=1e-10, err_msg=f"ray_losses[{k}]")
    assert np.asarray(ref["n_intersections"]).sum() > 0


def test_render_image_matches_jax_float32():
    """48x48 camera on the JAX make_gt_grid(16) with the serving options.
    The JAX package generates these rays on the device in float32
    (Camera.gen_rays_device), so this comparison runs in float32 on both
    sides, at atol 1e-5. The JAX side renders 48-ray chunks: its compositor
    takes per-ray prefixes as a chunk-wide float32 cumsum minus a per-ray
    base, whose error grows with the chunk (about 4e-4 at 2304 rays); the
    port's per-ray running sums do not depend on the chunk. The port renders
    1000-ray chunks, so its overlapping tail chunk is exercised
    (2304 = 2 * 1000 + 304)."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical
    from alphasurf_torch.app.render_circle import circle_render_options

    gj = make_gt_grid(16, basis_dim=9)
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    c2w = pose_spherical(45.0, 35.0, 2.2)
    opt = circle_render_options()
    img_j, dep_j = j_render_image(gj, at.Camera.make(jnp.asarray(c2w), fx=58.0, width=48, height=48),
                                  at.RenderOptions(**dataclasses.asdict(opt)), chunk=48,
                                  return_depth=True)
    cam = pt.Camera.make(c2w, fx=58.0, width=48, height=48)
    img_t, dep_t = pt.render_image(gt, cam, opt, chunk=1000, return_depth=True, device="cpu")
    assert img_t.dtype == np.float32 and img_t.shape == (48, 48, 3)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dep_t, dep_j, rtol=0, atol=1e-5 * float(dep_j.max()))
    assert np.abs(img_j - 1.0).max() > 0.2  # the sphere is in view
    whole = pt.render_image(gt, cam, opt, chunk=4096, device="cpu")
    np.testing.assert_allclose(whole, img_t, rtol=0, atol=1e-6)


def test_float32_ray_bounds_drop_the_same_rays_as_jax():
    """A fault of the JAX package that the port keeps (ROADMAP §3): in
    float32, ray_bounds tests plane hits against the lattice with an
    absolute 1e-6 band, below the roundoff of o + t*d at these coordinates,
    so some rays lose their exit and render empty; in float64 they hit."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical
    from alphasurf_tpu.ops.dda import preprocess_rays, ray_bounds
    from alphasurf_torch.ops import dda as tdda

    gj = make_gt_grid(16, basis_dim=9)
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    cam = at.Camera.make(jnp.asarray(pose_spherical(30.0, 20.0, 2.7)), fx=58.0, width=48, height=48)
    rays = cam.gen_rays_device()
    oj, dj, _, _ = preprocess_rays(gj, rays.origins, rays.dirs)
    tn_j, tx_j = ray_bounds(gj, oj, dj)
    ot, dt, _, _ = tdda.preprocess_rays(gt, t64(rays.origins).float(), t64(rays.dirs).float())
    tn_t, tx_t = tdda.ray_bounds(gt, ot, dt)
    np.testing.assert_array_equal(tn_t.numpy(), np.asarray(tn_j))
    np.testing.assert_array_equal(tx_t.numpy(), np.asarray(tx_j))
    g64 = SparseGrid.from_numpy(jax_to_np(gj), device="cpu", dtype=torch.float64)
    o64, d64, _, _ = tdda.preprocess_rays(g64, t64(rays.origins), t64(rays.dirs))
    tn64, tx64 = tdda.ray_bounds(g64, o64, d64)
    lost = (tx_t.numpy() <= tn_t.numpy()) & (tx64.numpy() > tn64.numpy() + 1.0)
    assert lost.sum() > 0


@pytest.mark.parametrize("renderer,compact", [("compact", None), ("dense", None),
                                              ("packed", True), ("packed", False)])
def test_render_image_renderers_match_jax_float32(renderer, compact):
    """render_image's ``renderer`` and its back-compat ``compact`` switch
    (True: compact, False: dense) against JAX's, float32, 32x32, rgb,
    depth and normal at atol 1e-5 (the JAX walks composite per ray, so no
    chunk-size cancellation enters). The compact renderer at K = 2 counts
    the occupied crossings it leaves out, as JAX does, and does not grow K."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical
    from alphasurf_torch.app.render_circle import circle_render_options

    gj = make_gt_grid(16, basis_dim=9)
    gt = SparseGrid.from_numpy(jax_to_np(gj), device="cpu")
    c2w = pose_spherical(45.0, 35.0, 2.2)
    opt = circle_render_options()
    K = 2
    img_j, dep_j, nrm_j = j_render_image(
        gj, at.Camera.make(jnp.asarray(c2w), fx=38.0, width=32, height=32),
        at.RenderOptions(**dataclasses.asdict(opt)), chunk=256, return_depth=True,
        return_normal=True, renderer=renderer, compact=compact, max_intersect_voxels=K)
    stats = {}
    img_t, dep_t, nrm_t = pt.render_image(
        gt, pt.Camera.make(c2w, fx=38.0, width=32, height=32), opt, chunk=300,
        return_depth=True, return_normal=True, renderer=renderer, compact=compact,
        max_intersect_voxels=K, device="cpu", stats=stats)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dep_t, dep_j, rtol=0, atol=1e-5 * float(dep_j.max()))
    np.testing.assert_allclose(nrm_t, nrm_j, rtol=0, atol=1e-5)
    assert np.abs(img_j - 1.0).max() > 0.2
    used = "compact" if compact else ("dense" if compact is False else renderer)
    assert (int(stats["overflow"]) > 0) == (used == "compact")
