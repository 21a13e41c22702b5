"""The gradient of the port's dense cuvol march (K10 backward's plain path)
and the output cotangents of both cuvol renderers against the JAX
package's jax.grad, and the cuvol step on every renderer (the dense march
whenever the step is not packed or has no occupancy) against JAX's
make_cuvol_step, in float64 on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import reg as j_reg
from alphasurf_tpu.render import cuvol as JC
from alphasurf_tpu.train import steps as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as t_reg
from alphasurf_torch.render import cuvol as TC
from alphasurf_torch.train import steps as T
from test_torch_background import bg_rays, np_background
from test_torch_basis import basis_arrays, jax_basis_grid
from test_torch_cuvol import _blobby, _rays
from test_torch_cuvol_step import HP, _grid, _jax_starts
from test_torch_util import jax_to_np, np_rays, t64

OUTPUTS = ("rgb", "depth", "log_transmit")


def _cotangents(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"rgb": rng.standard_normal((n, 3)), "depth": rng.standard_normal(n) * 0.1,
            "log_transmit": rng.standard_normal(n) * 0.1}


@functools.lru_cache(maxsize=None)
def _dense_grids():
    """The sphere-bounded blobby grid of test_torch_cuvol with a learned
    3D texture and a 3-layer MSI background: numpy arrays and JAX's grid."""
    _, a = _blobby(sphere_bound=True)
    a = basis_arrays(a, "texture")
    a["background_links"], a["background_data"] = np_background()
    gj = jax_basis_grid(a).replace(background_links=jnp.asarray(a["background_links"]),
                                   background_data=jnp.asarray(a["background_data"]))
    return a, gj


DENSE_FIELDS = ("density_data", "sh_data", "basis_data", "background_data")


@pytest.mark.parametrize("sphere", [False, True], ids=["box", "sphere"])
@pytest.mark.parametrize("lso", [False, True])
def test_dense_march_gradients_match_jax(lso, sphere):
    """d (rgb . c_rgb + depth . c_depth + log_transmit . c_log_T) /
    d density, SH, the texture and the background's rows through
    volume_render_cuvol: autograd of the port's plain march against one
    jitted jax.grad, rtol 1e-8 with a floor of 1e-8 of each array's
    largest entry; the outputs to rtol 1e-8. The 40 rays of
    test_torch_background (8 start inside the grid, 8 near the
    equirect's poles) at the Config's step 0.5; with last_sample_opaque a
    ray's last sample has log_att -1e9 sigma, d sigma -1e9 d log_att."""
    a, gj = _dense_grids()
    o, d = bg_rays()
    kw = dict(near_clip=0.05, last_sample_opaque=lso, use_spheric_clip=sphere)
    opt_j = at.RenderOptions(**kw)
    cot = _cotangents(o.shape[0], seed=21)

    def loss(vals, o_, d_):
        out = JC.volume_render_cuvol(gj.replace(**dict(zip(DENSE_FIELDS, vals))), at.Rays(o_, d_),
                                     opt_j)
        return sum(jnp.sum(out[k] * cot[k]) for k in OUTPUTS), {k: out[k] for k in OUTPUTS}

    (_, ref_out), ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tuple(getattr(gj, f) for f in DENSE_FIELDS), jnp.asarray(o), jnp.asarray(d))
    g = SparseGrid.from_numpy(a, device="cpu")
    params = [getattr(g, f).requires_grad_(True) for f in DENSE_FIELDS]
    out = TC.volume_render_cuvol(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**kw))
    for k in OUTPUTS:
        r = np.asarray(ref_out[k])
        np.testing.assert_allclose(out[k].detach().numpy(), r, rtol=1e-8,
                                   atol=1e-8 * max(np.abs(r).max(), 1.0), err_msg=k)
    grads = torch.autograd.grad(sum(torch.sum(out[k] * t64(cot[k])) for k in OUTPUTS), params)
    for f, x, r in zip(DENSE_FIELDS, grads, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 1e-3, f
        np.testing.assert_allclose(x.numpy(), r, rtol=1e-8, atol=1e-8 * np.abs(r).max(),
                                   err_msg=f)


@pytest.mark.parametrize("kw", [dict(near_clip=0.05),
                                dict(near_clip=0.05, last_sample_opaque=True),
                                dict(use_spheric_clip=True)], ids=["box", "box_lso", "sphere"])
def test_packed_output_cotangents_match_jax(kw):
    """The packed cuvol renderer's depth and log_transmit cotangents (beside
    rgb's) into density and SH: autograd of the plain path against one
    jitted jax.grad, rtol 1e-8 with a floor of 1e-8 of the largest entry;
    each of the two alone moves the density's gradient (and leaves SH's
    at 0)."""
    gj, a = _blobby()
    o, d = _rays()
    opt_j = at.RenderOptions(**kw)
    cot = _cotangents(o.shape[0], seed=22)

    @jax.jit
    def grad_j(dens, sh, scale):
        def loss(dens, sh):
            out = JC.volume_render_cuvol_packed(gj.replace(density_data=dens, sh_data=sh),
                                                at.Rays(jnp.asarray(o), jnp.asarray(d)), opt_j,
                                                entries_per_ray=64.0)
            return sum(s_k * jnp.sum(out[k] * cot[k]) for s_k, k in zip(scale, OUTPUTS))
        return jax.grad(loss, argnums=(0, 1))(dens, sh)

    g = SparseGrid.from_numpy(a, device="cpu")
    params = [g.density_data.requires_grad_(True), g.sh_data.requires_grad_(True)]
    out = TC.volume_render_cuvol_packed(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**kw))
    for keys in (OUTPUTS, ("depth",), ("log_transmit",)):
        scale = tuple(float(k in keys) for k in OUTPUTS)
        ref = grad_j(gj.density_data, gj.sh_data, jnp.asarray(scale))
        got = torch.autograd.grad(sum(torch.sum(out[k] * t64(cot[k])) for k in keys), params,
                                  retain_graph=True, allow_unused=True)
        for name, x, r in zip(("density", "sh"), got, ref):
            r = np.asarray(r)
            x = np.zeros_like(r) if x is None else x.numpy()
            if name == "density" or "rgb" in keys:
                assert np.abs(r).max() > 1e-3, (keys, name)
            np.testing.assert_allclose(x, r, rtol=1e-8, atol=1e-8 * max(np.abs(r).max(), 1e-3),
                                       err_msg=f"{keys} {name}")


@functools.lru_cache(maxsize=None)
def _jax_step(renderer):
    return J.make_cuvol_step(J.StepConfig(opt=at.RenderOptions(near_clip=0.05),
                                          renderer=renderer, entries_per_ray=64.0))


@pytest.mark.parametrize("renderer,with_occ", [("dense", True), ("compact", True),
                                               ("packed", False)],
                         ids=["dense", "compact", "packed_without_occ"])
def test_three_dense_cuvol_steps_match_jax(renderer, with_occ):
    """Three cuvol steps that train through the dense march (a renderer
    other than "packed", or no occupancy words) against JAX's, from the same
    grid, rms state and windows: loss and mse each step, then the rows and
    rms states, rtol 1e-8, as tests/test_torch_cuvol_step.py holds the
    packed step."""
    gj = _grid()
    a = jax_to_np(gj)
    o, d = np_rays(48, seed=4)
    gt = np.random.default_rng(5).uniform(0, 1, (48, 3))
    step_j = _jax_step(renderer)
    rms_j = J.init_rms(gj)
    rc_j = j_reg.row_coords_of(gj)
    cfg = T.StepConfig(opt=pt.RenderOptions(near_clip=0.05), renderer=renderer)
    g = SparseGrid.from_numpy(a, device="cpu")
    rms = T.init_rms(g)
    rc = t_reg.row_coords_of(g)
    step = T.make_cuvol_step(cfg)
    rays = pt.Rays(t64(o), t64(d))
    for i in range(3):
        key = jax.random.PRNGKey(i)
        occ_j = JC.density_occupancy(gj) if with_occ else None
        gj, rms_j, sj = step_j(gj, rms_j, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(gt), J.HParams(**HP), key, occ=occ_j, row_coords=rc_j)
        occ = TC.density_occupancy_words(g) if with_occ else None
        g, rms, st = step(g, rms, rays, t64(gt), T.HParams(**HP), torch.Generator(), occ=occ,
                          row_coords=rc, window_starts=_jax_starts(key, g, cfg, True))
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-8, err_msg=f"{i} {k}")
    for f in ("density_data", "sh_data"):
        got = getattr(g, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(gj, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
        assert np.abs(got - a[f]).max() > 1e-3, f
    got_rms = T.rms_to_numpy(rms)
    for k, v in rms_j.items():
        np.testing.assert_allclose(got_rms[k], np.asarray(v.rms), rtol=1e-8, atol=1e-20,
                                   err_msg=f"rms {k}")


def test_bench_step_dense_cuvol_runs_on_the_cpu():
    """app/bench_step.py --stage cuvol --renderer dense (the warm start of a
    compact or dense run) end to end at a tiny size."""
    from alphasurf_torch.app import bench_step

    out = bench_step.main(["--stage", "cuvol", "--renderer", "dense", "--reso", "16", "--batch",
                           "256", "--steps", "2", "--width", "64", "--device", "cpu"])
    assert out["stage"] == "cuvol" and out["renderer"] == "dense"
    assert out["first_loss"] < 0.24 and out["losses_finite"] and out["rows_moved"] > 0
    assert out["rays_per_s_fwd_bwd"] > 0 and out["card"] == "cpu"
