"""Gradients of the renderers' outputs other than rgb and the ray losses:
depth, normal, alpha, log_transmit, the mode, median and sigma-thresh
depths, the intersections' points, alphas and weights, the walks' samples
and the compat marches' depth, alpha and log_transmit. Autograd of the
port's plain paths against jax.grad of the JAX package's, float64 on the
CPU. Each case compiles one JAX program whose output weights are arguments,
so that the sum of every output and each output alone run through it (K5's
and K14's instantiations for these cotangents are held against the same
plain paths on the card by tests/test_torch_cuda.py and chip_smoke.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render import compat as JCm
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import compat as TCm
from alphasurf_torch.render import surface as TS
from alphasurf_torch.render.image import volume_render_depth
from test_torch_background import bg_rays, np_background
from test_torch_basis import basis_arrays, jax_basis_grid
from test_torch_compat import OPTS as COMPAT_OPTS
from test_torch_compat import _arrays as compat_arrays
from test_torch_compat import _rays as compat_rays
from test_torch_types import type_arrays, type_rays
from test_torch_util import BASE, OPTION_SETS, jax_grid, np_grid, np_rays, t64

SURFACE_PARAMS = ("density_data", "surface_data", "sh_data", "fake_sample_std")
PER_RAY = ("depth", "normal", "alpha", "log_transmit", "depth_mode", "depth_med",
           "depth_sigma_thresh")
SAMPLE_KEYS = ("ts", "alphas", "weights")
SIG = 0.5  # the sigma-thresh depth's threshold, an alpha
K = 8  # cache_size
U = np.array([0.7, -0.4, 0.5])  # an intersection's point enters the loss as cos(p) . U

# name -> (renderer, grid, option set, cache_size, extras): "sig" the
# sigma-thresh depth, "isect" the intersections, "samples" return_samples
CASES = {
    # the packed renderer over an MSI background (log_transmit through
    # log_T_bg), every option of OPTION_SETS[4]
    "packed_background": ("packed", "background", OPTION_SETS[4], None, ("sig", "isect")),
    # the dense walk with a texture basis, its cache and its samples
    "dense_texture": ("dense", "texture", OPTION_SETS[2], K, ("samples",)),
    "compact": ("compact", "sdf", OPTION_SETS[3], None, ("samples",)),
    "plane": ("packed", "plane", {}, K, ("sig", "isect")),
    "udf": ("dense", "udf", {}, K, ()),
    "udf_alpha": ("compact", "udf_alpha", {}, K, ()),
    # two equal level sets: every crossing has two slots at one t, so the
    # median and sigma-thresh depths pick tied samples, whose cotangent
    # jax.grad splits evenly
    "udf_fake_sample_tied": ("packed", "udf_fake_sample_tied",
                             dict(surf_fake_sample=True, limited_fake_sample=True), None,
                             ("sig", "isect")),
    "voxel_face": ("dense", "voxel_face", {}, None, ()),
}


def _grid_arrays(kind: str):
    """(arrays, JAX grid, rays, the trained fields) of a case's grid."""
    if kind == "background":
        a = np_grid(12, seed=3, prune=0.1, basis_dim=4)
        a["background_links"], a["background_data"] = np_background()
        gj = jax_grid(a).replace(background_links=jnp.asarray(a["background_links"]),
                                 background_data=jnp.asarray(a["background_data"]))
        return a, gj, bg_rays(), SURFACE_PARAMS + ("background_data",)
    if kind == "texture":
        a = basis_arrays(np_grid(12, seed=3, prune=0.15, basis_dim=4), "texture")
        return a, jax_basis_grid(a), np_rays(48, seed=6), SURFACE_PARAMS + ("basis_data",)
    if kind == "sdf":
        a = np_grid(16, seed=3, prune=0.2)
        return a, jax_grid(a), np_rays(64, seed=4), SURFACE_PARAMS
    if kind == "udf_fake_sample_tied":
        a = type_arrays("udf_fake_sample", 8)
        a["level_set_data"] = np.repeat(a["level_set_data"][:1], 2)
    else:
        a = type_arrays(kind, 8)
    return a, jax_grid(a), type_rays(8), SURFACE_PARAMS


def _render_kw(renderer: str, cache, extras: tuple) -> tuple:
    """(JAX kwargs, port kwargs) of a renderer call."""
    kw = {} if cache is None else {"cache_size": cache}
    if renderer == "packed":
        kw.update(return_intersections="isect" in extras,
                  depth_sigma_thresh=SIG if "sig" in extras else None)
        return dict(kw, entries_per_ray=64.0), kw
    if "samples" in extras:
        kw["return_samples"] = True
    if renderer == "compact":
        kw["max_intersect_voxels"] = 32
    return kw, kw


def _terms(renderer: str, cache, extras: tuple) -> tuple:
    """The loss terms of a case: its per-ray outputs, "isect", the samples."""
    keys = [k for k in PER_RAY if k != "depth_sigma_thresh" or "sig" in extras]
    if renderer != "packed" and cache is None:
        keys.remove("depth_med")  # the walks' median comes from the cache
    if "isect" in extras:
        keys.append("isect")
    if "samples" in extras:
        keys += SAMPLE_KEYS
    return tuple(keys)


def _weights(out_shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1.0, 1.0, s) for k, s in out_shapes.items()}


def _loss(out, W: dict, xp, where, cos, asarray):
    """sum_k W[k] * out[k] over the terms in W: the per-ray outputs, the
    intersections' cos(p) . U + 0.7 alpha - 0.4 weight over their real
    contributing slots (times W["isect"]) and the samples' ts, alphas and
    weights."""
    loss = 0.0
    for k, w in W.items():
        if k == "isect":
            it = out["intersections"]
            v = cos(it["pts"]) @ asarray(U) + 0.7 * it["alpha"] - 0.4 * it["weight"]
            loss = loss + asarray(w) * xp.sum(where(it["mask"], v, 0.0 * v))
        elif k in SAMPLE_KEYS:
            loss = loss + xp.sum(out["samples"][k] * asarray(w))
        else:
            loss = loss + xp.sum(out[k] * asarray(w))
    return loss


_J = dict(xp=jnp, where=jnp.where, cos=jnp.cos, asarray=jnp.asarray)
_T = dict(xp=torch, where=torch.where, cos=torch.cos, asarray=t64)

_J_RENDER = {"packed": JS.volume_render_surface_packed, "dense": JS.volume_render_surface,
             "compact": JS.volume_render_surface_compact}
_T_RENDER = {"packed": TS.volume_render_surface_packed, "dense": TS.volume_render_surface,
             "compact": TS.volume_render_surface_compact}


def _assert_grads(got, ref, fields, label: str) -> None:
    for f, gt, r in zip(fields, got, ref):
        r = np.asarray(r)
        gt = np.zeros_like(r) if gt is None else gt.numpy()
        np.testing.assert_allclose(gt, r, rtol=1e-8, atol=1e-11 * max(np.abs(r).max(), 1.0),
                                   err_msg=f"{label}: {f}")


@pytest.mark.parametrize("name", list(CASES))
def test_output_gradients_match_jax(name):
    """The gradient of a weighted sum of every output of the case, and of
    each output alone, with respect to every trained field (density,
    surface, SH, fake_sample_std and the case's background or texture)
    against jax.grad, rtol 1e-8. On the SDF grids each output alone moves
    the surface rows, and volume_render_depth with a threshold is the
    sigma-thresh depth."""
    renderer, kind, opt_kw, cache, extras = CASES[name]
    a, gj, (o, d), fields = _grid_arrays(kind)
    opt_kw = {**BASE, **opt_kw}
    jkw, tkw = _render_kw(renderer, cache, extras)
    j_render, t_render = _J_RENDER[renderer], _T_RENDER[renderer]
    g = SparseGrid.from_numpy(a, device="cpu")
    params = [getattr(g, f).requires_grad_(True) for f in fields]
    out = t_render(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw), **tkw)
    terms = _terms(renderer, cache, extras)
    shapes = {k: (() if k == "isect" else tuple(out["samples"][k].shape) if k in SAMPLE_KEYS
                  else tuple(out[k].shape)) for k in terms}
    W = _weights(shapes, seed=sum(map(ord, name)))

    def j_grad(vals, w):
        def loss(v):
            jout = j_render(gj.replace(**dict(zip(fields, v))),
                            at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(**opt_kw),
                            **jkw)
            return _loss(jout, w, **_J), jout.get("depth_sigma_thresh")

        return jax.value_and_grad(loss, has_aux=True)(vals)

    vals = tuple(getattr(gj, f) for f in fields)
    w_all = {k: jnp.asarray(v) for k, v in W.items()}
    j_grad = jax.jit(j_grad)
    (lj, t_sig), ref = j_grad(vals, w_all)
    loss = _loss(out, W, **_T)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-10)
    got = torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
    _assert_grads(got, ref, fields, "all outputs")
    for k in terms:
        wk = {j: (v if j == k else np.zeros_like(v)) for j, v in W.items()}
        _, ref_k = j_grad(vals, {j: jnp.asarray(v) for j, v in wk.items()})
        loss_k = _loss(out, {k: W[k]}, **_T)
        got_k = (torch.autograd.grad(loss_k, params, retain_graph=True, allow_unused=True)
                 if loss_k.requires_grad else [None] * len(params))
        _assert_grads(got_k, ref_k, fields, k)
        if kind in ("background", "texture", "sdf"):
            assert np.abs(np.asarray(ref_k[1])).max() > 0, k  # the surface moves it
    if kind != "voxel_face":
        assert np.abs(np.asarray(ref[1])).max() > 0
    if t_sig is not None:
        with torch.no_grad():
            depth = volume_render_depth(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw),
                                        sigma_thresh=SIG)
        np.testing.assert_allclose(depth.numpy(), np.asarray(t_sig), rtol=1e-8, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _compat_inputs():
    a = dict(compat_arrays())
    a.pop("basis_type")
    a.pop("basis_data")
    return a, jax_grid(a), compat_rays()


@pytest.mark.parametrize("opt_name", list(COMPAT_OPTS))
@pytest.mark.parametrize("mode", ["nvol", "svox1"])
def test_compat_output_gradients_match_jax(mode, opt_name):
    """The compat marches' depth, alpha (nvol) and log_transmit with rgb:
    the gradient of their weighted sum with respect to density and SH
    against jax.grad, rtol 1e-8 (nvol saturates on some rays)."""
    a, gj, (o, d) = _compat_inputs()
    opt_kw = COMPAT_OPTS[opt_name]
    keys = ("rgb", "depth", "log_transmit") + (("alpha",) if mode == "nvol" else ())
    rng = np.random.default_rng(21)
    W = {k: rng.uniform(-1.0, 1.0, (o.shape[0], 3) if k == "rgb" else o.shape[0]) for k in keys}
    j_render = JCm.volume_render_nvol if mode == "nvol" else JCm.volume_render_svox1
    t_render = TCm.volume_render_nvol if mode == "nvol" else TCm.volume_render_svox1
    fields = ("density_data", "sh_data")

    def j_loss(vals):
        out = j_render(gj.replace(**dict(zip(fields, vals))),
                       at.Rays(jnp.asarray(o), jnp.asarray(d)), at.RenderOptions(**opt_kw))
        return sum(jnp.sum(out[k] * W[k]) for k in keys)

    vals = tuple(getattr(gj, f) for f in fields)
    ref = jax.jit(jax.grad(j_loss))(vals)
    g = SparseGrid.from_numpy(a, device="cpu")
    params = [getattr(g, f).requires_grad_(True) for f in fields]
    out = t_render(g, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**opt_kw))
    got = torch.autograd.grad(sum(torch.sum(out[k] * t64(W[k])) for k in keys), params)
    _assert_grads(got, ref, fields, mode)
