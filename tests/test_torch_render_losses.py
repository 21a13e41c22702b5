"""The port's ``losses.render_losses`` against the JAX package's, float64
on the CPU: each sample loss and each two-pass cache loss, values and
gradients, on seeded inputs and on the samples the dense and compact
renderers return (``return_samples``), which equal JAX's slot for slot."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import render_losses as JL
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import render_losses as TL
from alphasurf_torch.render import surface as TS
from test_torch_util import BASE, OPTION_SETS, assert_outputs_match, np_grid, np_rays, t64

DIFF = ("alphas", "weights", "ts")


def _samples(seed=0, B=24, S=40):
    """Ascending ts, alphas and weights in [0, 1), a valid mask and fake
    samples among the valid ones; zeros off the valid slots, as the
    renderers write them. Two rays hold ties of the max weight."""
    rng = np.random.default_rng(seed)
    valid = rng.random((B, S)) < 0.6
    fake = valid & (rng.random((B, S)) < 0.2)
    ts = np.cumsum(rng.uniform(0.05, 0.5, (B, S)), axis=1) * valid
    alphas = rng.uniform(0, 0.9, (B, S)) * valid
    weights = rng.uniform(0, 0.5, (B, S)) * valid
    weights[0, :] = weights[0].max() * valid[0]
    weights[1, 3] = weights[1, 9] = 0.7
    valid[1, 3] = valid[1, 9] = True
    return {"ts": ts, "alphas": alphas, "weights": weights, "fake_mask": fake, "valid": valid}


def _jax(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _torch(x):
    return {k: torch.tensor(v, requires_grad=k in DIFF) for k, v in x.items()}


def _check(jfn, tfn, x):
    """Value and gradient (with respect to alphas, weights, ts) of one loss."""
    xj, xt = _jax(x), _torch(x)

    def f(*diff):
        return jfn({**xj, **dict(zip(DIFF, diff))})

    vj, gj = jax.value_and_grad(f, argnums=(0, 1, 2))(*(xj[k] for k in DIFF))
    vt = tfn(xt)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    gt = torch.autograd.grad(vt, [xt[k] for k in DIFF], allow_unused=True)
    for k, a, b in zip(DIFF, gt, gj):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-14, err_msg=k)
    return float(vt)


SAMPLE_LOSSES = [
    ("l_dist", dict(include_fake=True)), ("l_dist", dict(include_fake=False)),
    ("l_entropy", dict(include_fake=True)), ("l_entropy", dict(include_fake=False)),
    ("l_dist_alpha", dict(include_fake=False)), ("l_conv_mode_samp", {}),
    ("l_samp_dist", {}), ("l_sparsity", {}), ("density_lap_loss", {}),
]


@pytest.mark.parametrize("name,kw", SAMPLE_LOSSES)
def test_sample_losses_match_jax(name, kw):
    v = _check(functools.partial(getattr(JL, name), **kw),
               functools.partial(getattr(TL, name), **kw), _samples())
    assert v != 0.0


@pytest.mark.parametrize("name", ["l_conv_mode_samp_from_cache", "l_samp_dist_from_cache"])
def test_cache_losses_match_jax(name):
    """On a first-K cache: written slots first, n_cached of them, zeros
    after; fake slots and a ray with nothing cached."""
    s = _samples(1, S=16)
    n_cached = s["valid"].sum(1).astype(np.int32)
    n_cached[2] = 0
    order = np.argsort(~s["valid"], axis=1, kind="stable")  # the valid slots first
    cache = {k: np.take_along_axis(s[k], order, 1) for k in ("ts", "alphas", "weights", "fake_mask")}
    keep = np.arange(16)[None, :] < n_cached[:, None]
    cache = {k: v * keep if v.dtype != bool else v & keep for k, v in cache.items()}
    cache["n_cached"] = n_cached
    assert _check(getattr(JL, name), getattr(TL, name), cache) != 0.0


def test_streaming_reducers_match_jax():
    rng = np.random.default_rng(2)
    keys = ("l_dist", "l_dist_a", "l_entropy", "l_entropy_a", "sp_logsig", "sp_logsig_w", "sp_w",
            "l_inward", "lap_sum", "lap_cnt", "udf_var_sum", "udf_var_cnt")
    rl = {k: rng.uniform(0, 2, 16) for k in keys}
    rj, rt = _jax(rl), {k: torch.tensor(v) for k, v in rl.items()}
    for name, kw in (("l_dist_from_ray_losses", dict(alphas=True)),
                     ("l_dist_from_ray_losses", dict(alphas=False)),
                     ("l_entropy_from_ray_losses", dict(alphas=True)),
                     ("l_entropy_from_ray_losses", dict(alphas=False)),
                     ("l_sparsity_from_ray_losses", {}), ("l_inward_norm_from_ray_losses", {}),
                     ("density_lap_from_ray_losses", {}), ("udf_var_from_ray_losses", {})):
        np.testing.assert_allclose(float(getattr(TL, name)(rt, **kw)),
                                   float(getattr(JL, name)(rj, **kw)), rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("renderer", ["dense", "compact"])
def test_renderer_samples_and_their_losses_match_jax(renderer):
    """``return_samples`` of the dense walk (max_voxels slots a ray) and of
    the compact renderer (K rounded up to voxel_chunk), laid out as JAX's
    scans lay them out, and every sample loss on them; the first-K cache
    equals the samples' first K contributing ones."""
    a = np_grid(12, seed=3, prune=0.2)
    o, d = np_rays(32, seed=4)
    kw = {**BASE, **OPTION_SETS[4]}
    if renderer == "dense":
        fj, ft = JS.volume_render_surface, TS.volume_render_surface
        extra = {}
    else:
        fj, ft = JS.volume_render_surface_compact, TS.volume_render_surface_compact
        extra = dict(max_intersect_voxels=5, voxel_chunk=2)
    from test_torch_util import jax_grid

    ref = fj(jax_grid(a), at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(**kw),
             return_samples=True, cache_size=8, **extra)
    got = ft(SparseGrid.from_numpy(a, device="cpu"), pt.Rays(t64(o), t64(d)),
             pt.RenderOptions(**kw), return_samples=True, cache_size=8, **extra)
    assert_outputs_match(got, ref)
    sj, st = ref["samples"], got["samples"]
    for name, lkw in SAMPLE_LOSSES:
        np.testing.assert_allclose(float(getattr(TL, name)(st, **lkw)),
                                   float(getattr(JL, name)(sj, **lkw)), rtol=1e-9, err_msg=name)
    valid = st["valid"]
    first = torch.cumsum(valid.long(), 1) <= 8
    for k in ("ts", "weights"):
        cached = [st[k][b][valid[b] & first[b]] for b in range(valid.shape[0])]
        for b, c in enumerate(cached):
            np.testing.assert_array_equal(got["cache"][k][b, :len(c)].numpy(), c.numpy())
