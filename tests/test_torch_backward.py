"""Gradients of the port's packed renderer against jax.grad of the JAX
package's, in float64 on the CPU (the plain path under autograd; the CUDA
backward K5 is held against the same plain path by chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.ops.cubic import cubic_roots_T as j_roots
from alphasurf_tpu.render.surface import volume_render_surface_packed as j_render
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.ops.cubic import cubic_roots_T as t_roots
from alphasurf_torch.render.surface import volume_render_surface_packed as t_render
from test_torch_util import BASE, OPTION_SETS, jax_grid, jax_to_np, np_grid, np_rays, t64

# every ray-loss key that carries a gradient (sp_w and lap_cnt do not; the
# udf terms are zero on SDF grids)
DIFF_KEYS = ("l_dist", "l_dist_a", "l_entropy", "l_entropy_a", "sp_logsig", "sp_logsig_w",
             "l_inward", "lap_sum")
PARAMS = ("density_data", "sh_data", "surface_data", "fake_sample_std")


def _cubics(n=256, seed=0):
    """Random cubics, a quarter of them with a near-double root."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((4, n))
    a, b = rng.uniform(-1, 1, n // 4), rng.uniform(-1, 1, n // 4)
    eps = 10.0 ** rng.uniform(-9, -4, n // 4)
    # (t - a)^2 (t - b) + eps: two roots within ~sqrt(eps) of a
    f[0, : n // 4] = -a * a * b + eps
    f[1, : n // 4] = a * a + 2 * a * b
    f[2, : n // 4] = -(2 * a + b)
    f[3, : n // 4] = 1.0
    return f


def test_cubic_root_gradient_matches_jax():
    f = _cubics()
    w = np.random.default_rng(1).standard_normal((3, f.shape[1]))
    ref_roots = np.asarray(j_roots(*(jnp.asarray(x) for x in f)))
    ref = jax.grad(lambda *c: jnp.sum(j_roots(*c) * w), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in f))
    ft = [t64(x).requires_grad_(True) for x in f]
    roots = t_roots(*ft)
    got = torch.autograd.grad((roots * t64(w)).sum(), ft)
    np.testing.assert_allclose(roots.detach().numpy(), ref_roots, rtol=1e-12, atol=1e-12)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9, err_msg=f"f{i}")
    # the near-double roots reach the 1/eps clamp of f' somewhere
    assert np.abs(np.asarray(ref[0])).max() > 1e3
    assert all(np.isfinite(g.numpy()).all() for g in got)


def _loss_weights(B, seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (B, 3)), {k: rng.uniform(0.5, 1.5, B) * 0.1 for k in DIFF_KEYS}


@pytest.mark.parametrize("kw", OPTION_SETS)
def test_packed_render_gradients_match_jax(kw):
    a = np_grid(16, seed=3, prune=0.2)
    o, d = np_rays(64, seed=4)
    w_rgb, w_rl = _loss_weights(64)
    opt_kw = {**BASE, **kw}

    gj = jax_grid(a)
    rays_j = at.Rays(jnp.asarray(o), jnp.asarray(d))

    def j_loss(density, sh, surface, fss):
        out = j_render(gj.replace(density_data=density, sh_data=sh, surface_data=surface,
                                  fake_sample_std=fss), rays_j, at.RenderOptions(**opt_kw),
                       entries_per_ray=48)
        loss = jnp.sum(out["rgb"] * w_rgb)
        for k in DIFF_KEYS:
            loss = loss + jnp.sum(out["ray_losses"][k] * w_rl[k])
        return loss, out["pool_overflow"]

    # compiled whole: ~7 s on the CPU, where an eager first call compiles
    # every primitive anew (~60 s); float64 results agree to ~1e-14
    (lj, overflow), ref = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a[k]) for k in PARAMS))
    assert int(overflow) == 0

    gt = SparseGrid.from_numpy(a, device="cpu")
    params = [getattr(gt, k).requires_grad_(True) for k in PARAMS]
    out = t_render(gt, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw))
    loss = (out["rgb"] * t64(w_rgb)).sum()
    for k in DIFF_KEYS:
        loss = loss + (out["ray_losses"][k] * t64(w_rl[k])).sum()
    got = torch.autograd.grad(loss, params, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-10)
    for name, g, r in zip(PARAMS, got, ref):
        g = np.zeros_like(np.asarray(r)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-7, atol=1e-10, err_msg=name)
    assert np.abs(np.asarray(ref[2])).max() > 0  # the surface moves the image
    if kw.get("surf_fake_sample"):
        assert abs(float(ref[3][0, 0])) > 0


def test_packed_gradients_finite_with_invalid_entries_float32():
    """The float32 regression of test_surface_packed.py:163 (corner-crossing
    camera rays, huge cubic pseudo-roots): gradients stay finite."""
    from alphasurf_tpu.data.synthetic import make_gt_grid

    a = jax_to_np(make_gt_grid(16))
    a["fake_sample_std"] = np.full((1, 1), 0.2, np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.5
    rays = at.Camera.make(jnp.asarray(c2w), fx=60.0, width=48, height=48).gen_rays()
    g = SparseGrid.from_numpy(a, device="cpu", dtype=torch.float32)
    opt = pt.RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True,
                           surf_fake_sample=True, limited_fake_sample=True,
                           truncated_vol_render=True)
    params = [g.surface_data.requires_grad_(True), g.density_data.requires_grad_(True)]
    out = t_render(g, pt.Rays(torch.as_tensor(np.array(rays.origins)),
                              torch.as_tensor(np.array(rays.dirs))), opt)
    loss = (out["rgb"] ** 2).mean() + 1e-3 * out["ray_losses"]["l_dist"].sum()
    gs, gd = torch.autograd.grad(loss, params)
    assert torch.isfinite(gs).all() and torch.isfinite(gd).all()
    assert gs.abs().max() > 0 and gd.abs().max() > 0

