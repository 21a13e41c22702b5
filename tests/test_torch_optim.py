"""The port's RMSprop and the ray-loss reducers against the JAX package's
``optim.rmsprop`` and ``losses.render_losses``, in float64 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.losses import render_losses as JL
from alphasurf_tpu.optim import rmsprop as JO
from alphasurf_torch.losses import render_losses as TL
from alphasurf_torch.optim import rmsprop as TO
from alphasurf_torch.render.surface import _RAY_LOSS_KEYS
from test_torch_util import t64  # noqa: F401  (one torch thread, as every port test)


def _state(rows=64, C=27, seed=0):
    rng = np.random.default_rng(seed)
    param = rng.standard_normal((rows, C))
    rms = rng.uniform(0, 1e-2, (rows, C))
    grad = rng.standard_normal((rows, C)) * 1e-2
    grad[rng.random(rows) < 0.3] = 0.0  # untouched rows
    grad[0, :-1] = 0.0  # a row with one nonzero channel still steps
    return param, rms, grad


@pytest.mark.parametrize("C,kw", [
    (27, dict()),
    (1, dict(minval=0.05)),
    (1, dict(grad_abs_max=3e-3)),
    (1, dict(frozen=True)),
])
def test_rmsprop_matches_jax(C, kw):
    param, rms, grad = _state(C=C)
    g_j = jnp.asarray(grad)
    mask = None
    if "grad_abs_max" in kw:
        g_j = jnp.clip(g_j, -kw["grad_abs_max"], kw["grad_abs_max"])
    if kw.get("frozen"):
        mask = jnp.any(g_j != 0, axis=-1, keepdims=True) & False
    p_ref, s_ref = JO.rmsprop_step(jnp.asarray(param), JO.RMSState(jnp.asarray(rms)), g_j, 1e-2,
                                   0.95, minval=kw.get("minval"), mask=mask)
    p, r = torch.tensor(param), torch.tensor(rms)
    TO.rmsprop_step(p, r, torch.tensor(grad), 1e-2, 0.95, **kw)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(r.numpy(), np.asarray(s_ref.rms), rtol=1e-13, atol=1e-18)
    untouched = ~np.any(grad != 0, axis=-1) | bool(kw.get("frozen"))
    floor = kw.get("minval", -np.inf)
    np.testing.assert_array_equal(p.numpy()[untouched], np.maximum(param, floor)[untouched])
    assert (p.numpy() != param).any() != bool(kw.get("frozen"))


def test_sgd_matches_jax():
    param, _, grad = _state()
    ref = JO.sgd_step(jnp.asarray(param), jnp.asarray(grad), 0.5)
    p = torch.tensor(param)
    TO.sgd_step(p, torch.tensor(grad), 0.5)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref), rtol=1e-14)


REDUCERS = [
    ("l_dist_from_ray_losses", dict(alphas=False)),
    ("l_dist_from_ray_losses", dict(alphas=True)),
    ("l_entropy_from_ray_losses", dict(alphas=False)),
    ("l_entropy_from_ray_losses", dict(alphas=True)),
    ("l_sparsity_from_ray_losses", dict()),
    ("l_inward_norm_from_ray_losses", dict()),
    ("density_lap_from_ray_losses", dict()),
    ("udf_var_from_ray_losses", dict()),
]


@pytest.mark.parametrize("name,kw", REDUCERS)
def test_ray_loss_reducers_match_jax(name, kw):
    rng = np.random.default_rng(1)
    rl = {k: rng.uniform(0, 2, 32) for k in _RAY_LOSS_KEYS}
    rl["sp_w"][:4] = 0.0  # rays that hit nothing
    rl["lap_cnt"] = np.floor(rl["lap_cnt"] * 3)
    ref_v, ref_g = jax.value_and_grad(lambda d: getattr(JL, name)(d, **kw))(
        {k: jnp.asarray(v) for k, v in rl.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in rl.items()}
    v = getattr(TL, name)(t, **kw)
    np.testing.assert_allclose(float(v.detach()), float(ref_v), rtol=1e-13)
    got = torch.autograd.grad(v, list(t.values()), allow_unused=True)
    for k, g in zip(t, got):
        g = np.zeros(32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(ref_g[k]), rtol=1e-12, atol=1e-15, err_msg=k)
