"""The packed cuvol renderer (K8's plain path) against the JAX package's on
long rays: a thin (72, 4, 4) grid whose rays run along x through up to 71
occupied voxels, past two of the K8 kernel's 32-entry groups (the kernel is
held to this plain path on the card). Outputs and the gradients of rgb,
depth and log_transmit in float64 on the CPU, with depth_sigma_thresh,
last_sample_opaque and an MSI background (a colour per ray)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render import cuvol as JC
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import cuvol as TC
from test_torch_background import np_background
from test_torch_util import jax_grid, t64

RESO = (72, 4, 4)
# entries of the rays that start inside the grid; the others cross it whole
LENGTHS = (0, 1, 31, 32, 33, 64, 65)


def thin_grid(seed=0, basis_dim=4, background=False) -> dict:
    """float64 numpy arrays of a dense thin grid: density mostly positive
    (negative at about one vertex in eight, relu's zero side), random SH,
    and, with ``background``, a 3-layer MSI."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(RESO))
    a = {
        "links": np.arange(n, dtype=np.int32).reshape(RESO),
        "density_data": rng.uniform(-0.15, 0.6, (n, 1)),
        "sh_data": rng.standard_normal((n, 3 * basis_dim)) * 0.3,
        "radius": np.ones(3),
        "center": np.zeros(3),
        "basis_dim": basis_dim,
        "surface_type": at.defs.SURFACE_TYPE_NONE,
    }
    for k in ("surface_data", "level_set_data", "fake_sample_std", "truncated_vol_render_a"):
        a[k] = None
    if background:
        a["background_links"], a["background_data"] = np_background(nlayers=3)
    return a


def thin_rays(seed=1):
    """World rays along +x near the grid's axis: one starting inside for
    each of LENGTHS (0: behind the grid's far face), and five from outside
    the grid, slightly tilted."""
    rng = np.random.default_rng(seed)
    X = RESO[0]
    o_g, d_g = [], []
    for n in LENGTHS:
        o_g.append([X + 3.0 if n == 0 else X - 1 - n + rng.uniform(0.2, 0.8),
                    rng.uniform(1.3, 1.7), rng.uniform(1.3, 1.7)])
        d_g.append([1.0, rng.uniform(-0.004, 0.004), rng.uniform(-0.004, 0.004)])
    for _ in range(5):
        o_g.append([-3.0, rng.uniform(1.2, 1.8), rng.uniform(1.2, 1.8)])
        d_g.append([1.0, rng.uniform(-0.008, 0.008), rng.uniform(-0.008, 0.008)])
    gsz = np.asarray(RESO, np.float64)
    o = np.asarray(o_g) * 2.0 / gsz - 1.0  # grid2world at radius 1, centre 0
    d = np.asarray(d_g) * 2.0 / gsz
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _jax_grid(a):
    gj = jax_grid({k: v for k, v in a.items() if not k.startswith("background")})
    if "background_links" in a:
        gj = gj.replace(background_links=jnp.asarray(a["background_links"]),
                        background_data=jnp.asarray(a["background_data"]))
    return gj


# render options and depth_sigma_thresh; the sphere clip puts tmax inside
# the lattice, so last_sample_opaque weights a sample of the pool
SETS = [
    (dict(near_clip=0.0), 0.4, False),
    (dict(near_clip=0.0, use_spheric_clip=True, last_sample_opaque=True), None, False),
    (dict(near_clip=0.0, step_size=0.3, background_brightness=0.7), 0.5, True),
]


@functools.lru_cache(maxsize=None)
def _jax_fn(set_i: int):
    kw, dst, _ = SETS[set_i]
    opt = at.RenderOptions(**kw)
    keys = ("rgb", "depth", "log_transmit") + (("depth_sigma_thresh",) if dst else ())

    def fwd(gj, vals, o, d):
        out = JC.volume_render_cuvol_packed(gj.replace(**vals), at.Rays(o, d), opt,
                                            entries_per_ray=80.0, depth_sigma_thresh=dst)
        return {k: out[k] for k in keys}

    def fwd_grad(gj, vals, o, d, cot):
        def loss(v):
            out = fwd(gj, v, o, d)
            return sum(jnp.sum(out[k] * cot[k]) for k in cot)
        return fwd(gj, vals, o, d), jax.grad(loss)(vals)

    return jax.jit(fwd_grad)


@pytest.mark.parametrize("set_i", range(len(SETS)))
def test_long_rays_match_jax(set_i):
    """rgb, depth, log_transmit (and depth_sigma_thresh) to rtol 1e-8, and
    the gradients of a weighted sum of rgb, depth and log_transmit with
    respect to density, SH (and the background's rows) to rtol 1e-8 (atol
    1e-10 of the largest entry). With last_sample_opaque the JAX renderer's
    chunk-wide prefix cancels at ulp(1e9) for the rays after a 1e9-weighted
    sample (ROADMAP §3, "Per-ray prefixes"), so JAX renders each ray alone
    and its gradients are summed over the rays. Even alone, JAX takes the
    opaque sample's own exclusive prefix as the inclusive cumsum minus its
    -1e9 sigma, exact only to ulp(1e9 sigma) ~ 6e-8 in float64, which moves
    its weight by as much relative (the port's per-ray scan shifts the
    cumsum and subtracts nothing): that set holds to rtol 1e-6."""
    kw, dst, background = SETS[set_i]
    a = thin_grid(background=background)
    o, d = thin_rays()
    B = o.shape[0]
    rng = np.random.default_rng(7)
    cot = {"rgb": rng.standard_normal((B, 3)), "depth": rng.standard_normal(B) * 0.05,
           "log_transmit": rng.standard_normal(B) * 0.3}
    fields = ("density_data", "sh_data") + (("background_data",) if background else ())
    gj = _jax_grid(a)
    vals = {f: getattr(gj, f) for f in fields}
    fn = _jax_fn(set_i)
    per_ray = kw.get("last_sample_opaque", False)
    parts = [(o[i:i + 1], d[i:i + 1], {k: v[i:i + 1] for k, v in cot.items()})
             for i in range(B)] if per_ray else [(o, d, cot)]
    outs, grads = zip(*[fn(gj, vals, jnp.asarray(oi), jnp.asarray(di),
                           {k: jnp.asarray(v) for k, v in ci.items()}) for oi, di, ci in parts])
    ref = {k: np.concatenate([np.asarray(x[k]).reshape(len(x[k]), -1) for x in outs])
           for k in outs[0]}
    ref_g = {f: sum(np.asarray(g[f]) for g in grads) for f in fields}

    g = SparseGrid.from_numpy(a, device="cpu", dtype=torch.float64)
    params = [getattr(g, f).requires_grad_(True) for f in fields]
    opt = pt.RenderOptions(**kw)
    got = TC.volume_render_cuvol_packed(g, pt.Rays(t64(o), t64(d)), opt, depth_sigma_thresh=dst)
    n_e = (got["n_occupied"]).numpy()
    assert n_e.max() >= 65 and {1, 31, 32, 33, 64, 65} <= set(n_e[:len(LENGTHS)].tolist())
    rtol = 1e-6 if per_ray else 1e-8
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy().reshape(B, -1), r, rtol=rtol,
                                   atol=1e-12, err_msg=k)
    loss = sum(torch.sum(got[k] * t64(v)) for k, v in cot.items())
    for f, x in zip(fields, torch.autograd.grad(loss, params)):
        r = ref_g[f]
        assert np.abs(r).max() > 1e-3, f
        np.testing.assert_allclose(x.numpy(), r, rtol=rtol, atol=1e-10 * np.abs(r).max(),
                                   err_msg=f)
