"""The MSI background (K13's path) against the JAX package's
``render.background``, in float64 on the CPU: ``render_background`` op for
op, every renderer's outputs over a background (links -1 in the equirect,
rays near the poles and rays that start inside the grid, a brightness other
than 1), the gradients of ``background_data`` and of the foreground rows,
and the two background regularizers (K12e, K12f)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import reg as JR
from alphasurf_tpu.render import background as JB
from alphasurf_tpu.render import cuvol as JC
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as TR
from alphasurf_torch.render import background as TB
from alphasurf_torch.render import cuvol as TC
from alphasurf_torch.render import surface as TS
from test_torch_util import BASE, jax_grid, np_grid, np_rays, t64

OPT = dict(BASE, background_brightness=0.7, step_size=0.5)


def np_background(R=8, nlayers=3, seed=5, missing=0.15):
    """(2R, R) links with about ``missing`` of them -1, rows in a shuffled
    order, and (n, nlayers, 4) rgba rows whose density is negative in
    places (relu's zero side)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(2 * R * R) >= missing
    n = int(keep.sum())
    links = np.full(2 * R * R, -1, np.int32)
    links[keep] = rng.permutation(n).astype(np.int32)
    data = rng.standard_normal((n, nlayers, 4)) * 0.8
    data[..., 3] += 0.8
    return links.reshape(2 * R, R), data


def bg_rays(seed=2):
    """40 rays: 24 from outside the grid, 8 that start inside it, and 8
    near the poles of the equirect (y), one of them on the pole."""
    rng = np.random.default_rng(seed)
    o_out, d_out = np_rays(24, seed=seed)
    o_in = rng.uniform(-0.4, 0.4, (8, 3))
    d_in = rng.standard_normal((8, 3))
    d_pole = np.concatenate([rng.uniform(-0.03, 0.03, (8, 1)), np.ones((8, 1)),
                             rng.uniform(-0.03, 0.03, (8, 1))], -1)
    d_pole[4:, 1] = -1.0
    d_pole[0] = (0.0, 1.0, 0.0)
    o_pole = rng.uniform(-0.3, 0.3, (8, 3)) - 2.5 * d_pole
    o = np.concatenate([o_out, o_in, o_pole])
    d = np.concatenate([d_out, d_in, d_pole])
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _grids(nlayers=3):
    a = np_grid(12, seed=3, prune=0.1, basis_dim=4)
    a["background_links"], a["background_data"] = np_background(nlayers=nlayers)
    gj = jax_grid(a).replace(background_links=jnp.asarray(a["background_links"]),
                             background_data=jnp.asarray(a["background_data"]))
    return a, gj


def _port(a):
    return SparseGrid.from_numpy(a, device="cpu", dtype=torch.float64)


def test_render_background_matches_jax():
    """The plain K13 against JAX's function, from a foreground's log_T and
    rgb, at 3 layers and at 1 (where lz + 1 reads out of range and JAX's
    gather clamps it)."""
    o, d = bg_rays()
    rng = np.random.default_rng(9)
    log_T = -rng.uniform(0, 2, o.shape[0])
    rgb = rng.uniform(0, 1, o.shape)
    opt_j, opt_t = at.RenderOptions(**OPT), pt.RenderOptions(**OPT)
    for nlayers in (3, 1):
        a, gj = _grids(nlayers)
        g = _port(a)
        oj, dj, _, ds = JS.dda.preprocess_rays(gj, jnp.asarray(o), jnp.asarray(d))
        ref = JB.render_background(gj, opt_j, oj, dj, ds, jnp.asarray(log_T), jnp.asarray(rgb))
        got = TB.render_background(g, opt_t, t64(oj), t64(dj), t64(ds), t64(log_T), t64(rgb))
        for r, t in zip(ref, got):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-10, atol=1e-13)
    uv = TB.xyz2equirect(t64(d), 8).numpy()
    np.testing.assert_allclose(uv, np.asarray(JB.xyz2equirect(jnp.asarray(d), 8)), rtol=1e-12)


def _jax_render(name, gj, o, d, opt):
    rays = at.Rays(o, d)
    if name == "packed":
        return JS.volume_render_surface_packed(gj, rays, opt, entries_per_ray=64.0)
    if name == "compact":
        return JS.volume_render_surface_compact(gj, rays, opt, max_intersect_voxels=64)
    if name == "dense":
        return JS.volume_render_surface(gj, rays, opt)
    if name == "cuvol_packed":
        return JC.volume_render_cuvol_packed(gj, rays, opt, entries_per_ray=64.0)
    return JC.volume_render_cuvol(gj, rays, opt)


def _port_render(name, g, o, d, opt):
    rays = pt.Rays(t64(o), t64(d))
    if name == "packed":
        return TS.volume_render_surface_packed(g, rays, opt)
    if name == "compact":
        return TS.volume_render_surface_compact(g, rays, opt, max_intersect_voxels=64)
    if name == "dense":
        return TS.volume_render_surface(g, rays, opt)
    if name == "cuvol_packed":
        return TC.volume_render_cuvol_packed(g, rays, opt)
    return TC.volume_render_cuvol(g, rays, opt)


def _keys(name):
    return ("rgb", "log_transmit") + (("depth",) if name.startswith("cuvol") else ("alpha",))


def _trained_fields(name):
    return ("density_data", "sh_data", "background_data") + (
        () if name.startswith("cuvol") else ("surface_data",))


@pytest.mark.parametrize("name", ["packed", "compact", "dense", "cuvol_packed", "cuvol_dense"])
def test_renderers_with_background_match_jax(name):
    """rgb, log_transmit and (surface) alpha, or (cuvol) depth, to rtol
    1e-8, the background moving every ray's rgb; for the two renderers the
    steps train through (packed, cuvol packed) also the gradients of a
    weighted sum of rgb with respect to background_data and the foreground
    rows, against jax.grad (one jitted vjp), rtol 1e-8."""
    a, gj = _grids()
    o, d = bg_rays()
    opt_j, opt_t = at.RenderOptions(**OPT), pt.RenderOptions(**OPT)
    fields = _trained_fields(name)
    with_grad = name in ("packed", "cuvol_packed")
    w = np.random.default_rng(11).standard_normal((o.shape[0], 3))

    def fwd(vals, o_, d_):
        out = _jax_render(name, gj.replace(**dict(zip(fields, vals))), o_, d_, opt_j)
        return {k: out[k] for k in _keys(name)}

    def fwd_grad(v, o_, d_):
        return fwd(v, o_, d_), jax.grad(lambda v2: jnp.sum(fwd(v2, o_, d_)["rgb"] * w))(v)

    fn = fwd_grad if with_grad else fwd
    if name in ("packed", "compact", "cuvol_packed"):  # quicker jitted; the others eagerly
        fn = jax.jit(fn)
    res = fn(tuple(getattr(gj, f) for f in fields), jnp.asarray(o), jnp.asarray(d))
    ref, ref_g = res if with_grad else (res, None)
    g = _port(a)
    params = [getattr(g, f) for f in fields]
    for p in params:
        p.requires_grad_(with_grad)
    got = _port_render(name, g, o, d, opt_t)
    for k in _keys(name):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    plain = _port_render(name, g.replace(background_links=None, background_data=None), o, d,
                         opt_t)
    assert np.all(np.abs((plain["rgb"] - got["rgb"]).detach().numpy()).max(-1) > 1e-6)
    if with_grad:
        grads = torch.autograd.grad(torch.sum(got["rgb"] * t64(w)), params)
        for f, r, t in zip(fields, ref_g, grads):
            r = np.asarray(r)
            assert np.abs(r).max() > 0, f
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-8, atol=1e-12 * np.abs(r).max(),
                                       err_msg=f)


def test_background_tv_matches_jax():
    """K12f's plain version: loss and row gradient against JAX's, at JAX's
    own cells (jax.random.randint, as the step draws them)."""
    a, gj = _grids()
    n_bg = a["background_links"].size * a["background_data"].shape[1]
    cells = jax.random.randint(jax.random.PRNGKey(3), (300,), 0, n_bg, dtype=jnp.int32)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda bd: JR.background_tv_loss(gj.replace(background_data=bd), cells, 0.3, 0.05)))(
        gj.background_data)
    g = _port(a)
    g.background_data.requires_grad_(True)
    loss = TR.background_tv_loss(g, torch.as_tensor(np.asarray(cells)), 0.3, 0.05)
    (got_g,) = torch.autograd.grad(loss, [g.background_data])
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-10)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-10, atol=1e-15)


@pytest.mark.parametrize("dir_factor", [1.0, 0.0])
def test_lumisphere_tv_matches_jax(dir_factor):
    """K12e's plain version at JAX's own cells and directions (drawn from
    its key as reg.py:748-762 draws them): loss and SH gradient."""
    a, gj = _grids()
    key = jax.random.PRNGKey(7)
    cells = JR.sample_cells(jax.random.PRNGKey(8), gj, 0.2)
    ref, ref_g = jax.jit(jax.value_and_grad(lambda sh: JR.lumisphere_tv_loss(
        gj.replace(sh_data=sh), cells, key, dir_factor=dir_factor)))(gj.sh_data)
    k_dir, k_axis = jax.random.split(key)
    d = jax.random.normal(k_dir, (3,))
    d = d / jnp.linalg.norm(d)
    axis = jax.random.normal(k_axis, (3,))
    axis = axis / jnp.linalg.norm(axis) * 0.05
    th = jnp.linalg.norm(axis)
    k = axis / jnp.maximum(th, 1e-12)
    d_p = d * jnp.cos(th) + jnp.cross(k, d) * jnp.sin(th) + k * jnp.dot(k, d) * (1 - jnp.cos(th))
    g = _port(a)
    g.sh_data.requires_grad_(True)
    loss = TR.lumisphere_tv_at(g, torch.as_tensor(np.asarray(cells)), np.asarray(d),
                               np.asarray(d_p), dir_factor=dir_factor)
    (got_g,) = torch.autograd.grad(loss, [g.sh_data])
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-10)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-10, atol=1e-15)
    # the port's own draw: a unit direction and its twin turned by 0.05 rad
    # about an axis (at most 0.05 rad away)
    dt, dpt = TR.lumisphere_directions(torch.Generator().manual_seed(0))
    assert abs(float(torch.linalg.norm(dt)) - 1.0) < 1e-12
    assert abs(float(torch.linalg.norm(dpt)) - 1.0) < 1e-12
    assert 0 < float(torch.arccos(torch.clamp(torch.dot(dt, dpt), -1, 1))) <= 0.05 + 1e-12


# ---------------------------------------------------------------------------
# the steps with the background group
# ---------------------------------------------------------------------------

# the background trained (lr_background > 0); the sampled background and
# lumisphere terms run at weight 0, since the two packages draw their cells
# and directions differently
BG_HP = dict(lr_background=1e-2, lambda_tv_background=0.0, lambda_tv_background_density=0.0,
             lambda_tv_lumisphere=0.0)


def _with_background(gj, a):
    a = dict(a)
    a["background_links"], a["background_data"] = np_background()
    return gj.replace(background_links=jnp.asarray(a["background_links"]),
                      background_data=jnp.asarray(a["background_data"])), a


@pytest.mark.parametrize("kind", ["surface", "cuvol"])
def test_steps_train_the_background_like_jax(kind):
    """Two steps of each package from the same grid (its background
    included), rms state and windows, float64: loss and mse each step, then
    every trained array and its rms state, the background's among them, to
    rtol 1e-8; the background moved. The surface step also runs the
    lumisphere term (use_lumisphere_tv, weight 0)."""
    from alphasurf_tpu.render.cuvol import density_occupancy as jax_density_occupancy
    from alphasurf_tpu.train import steps as J
    from alphasurf_torch.render.cuvol import density_occupancy_words
    from alphasurf_torch.train import steps as T
    from test_torch_util import jax_to_np

    if kind == "surface":
        import test_torch_step as S

        a = np_grid(12, seed=3, prune=0.1)
        gj, a = _with_background(jax_grid(a), a)
        opt_kw, hp, extra = S.OPT, {**S.HP, **BG_HP}, dict(use_lumisphere_tv=True)
        make_j, make_t = J.make_surface_step, T.make_surface_step
        fields = ("density_data", "sh_data", "surface_data", "fake_sample_std", "background_data")
    else:
        import test_torch_cuvol_step as S

        g0 = S._grid()
        gj, a = _with_background(g0, jax_to_np(g0))
        opt_kw, hp, extra = dict(near_clip=0.05), {**S.HP, **BG_HP}, {}
        make_j, make_t = J.make_cuvol_step, T.make_cuvol_step
        fields = ("density_data", "sh_data", "background_data")
    o, d = bg_rays()
    gt = np.random.default_rng(5).uniform(0, 1, (o.shape[0], 3))
    cfg_j = J.StepConfig(opt=at.RenderOptions(**opt_kw), entries_per_ray=64.0, cache_size=None,
                         **extra)
    step_j = make_j(cfg_j)
    rms_j = J.init_rms(gj)
    rc_j = JR.row_coords_of(gj)
    cfg = T.StepConfig(opt=pt.RenderOptions(**opt_kw), cache_size=None, **extra)
    g = _port(a)
    rms = T.init_rms(g)
    assert set(rms) == set(rms_j) and "background" in rms
    rc = TR.row_coords_of(g)
    step = make_t(cfg)
    rays = pt.Rays(t64(o), t64(d))
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        key = jax.random.PRNGKey(i)
        kw_j, kw_t = {}, {}
        if kind == "cuvol":
            kw_j["occ"], kw_t["occ"] = jax_density_occupancy(gj), density_occupancy_words(g)
            starts = S._jax_starts(key, g, cfg, True)
        else:
            starts = S._jax_starts(key, g.capacity, cfg)
        gj, rms_j, sj = step_j(gj, rms_j, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(gt), J.HParams(**hp), key, row_coords=rc_j, **kw_j)
        g, rms, st = step(g, rms, rays, t64(gt), T.HParams(**hp), gen, row_coords=rc,
                          window_starts=starts, **kw_t)
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-8, err_msg=f"{i} {k}")
    for f in fields:
        np.testing.assert_allclose(getattr(g, f).detach().numpy(), np.asarray(getattr(gj, f)),
                                   rtol=1e-8, atol=1e-12, err_msg=f)
    assert np.abs(g.background_data.detach().numpy() - a["background_data"]).max() > 1e-4
    got_rms = T.rms_to_numpy(rms)
    for k, v in rms_j.items():
        np.testing.assert_allclose(got_rms[k], np.asarray(v.rms), rtol=1e-8, atol=1e-20,
                                   err_msg=f"rms {k}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["packed", "cuvol_packed"])
def test_background_kernels_match_plain_versions(cuda, name):
    """K13 forward and backward, through the renderers on the card, against
    the plain renderers on the CPU in float32: rgb and log_transmit, and
    the gradient of background_data."""
    from alphasurf_torch import kernels

    a, _ = _grids()
    a32 = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
               else v) for k, v in a.items()}
    o, d = bg_rays()
    w = np.random.default_rng(11).standard_normal((o.shape[0], 3))
    opt = pt.RenderOptions(**OPT)
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        g = SparseGrid.from_numpy(a32, device=dev)
        g.background_data.requires_grad_(True)
        rays = pt.Rays(torch.as_tensor(o, dtype=torch.float32, device=dev),
                       torch.as_tensor(d, dtype=torch.float32, device=dev))
        kernels.reset_launches()
        out = _render_on(name, g, rays, opt)
        loss = torch.sum(out["rgb"] * torch.as_tensor(w, dtype=torch.float32, device=dev))
        grads.append(torch.autograd.grad(loss, g.background_data)[0].cpu())
        outs.append({k: out[k].detach().cpu() for k in ("rgb", "log_transmit")})
        if dev.type == "cuda":
            assert kernels.LAUNCHES["background_forward"] > 0
            assert kernels.LAUNCHES["background_backward"] > 0
    for k in ("rgb", "log_transmit"):
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(), rtol=1e-4, atol=1e-5)
    scale = float(grads[1].abs().max())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-3, atol=1e-4 * scale)


def _render_on(name, g, rays, opt):
    if name == "packed":
        return TS.volume_render_surface_packed(g, rays, opt)
    return TC.volume_render_cuvol_packed(g, rays, opt)


@pytest.mark.cuda
def test_background_regularizer_kernels_match_plain_versions(cuda):
    """K12f and K12e on the card against their plain versions on the CPU in
    float32: loss and row gradient."""
    a, _ = _grids()
    a32 = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
               else v) for k, v in a.items()}
    n_bg = a["background_links"].size * a["background_data"].shape[1]
    cells_bg = np.random.default_rng(2).integers(0, n_bg, 300).astype(np.int32)
    cells = np.arange(0, 12 ** 3, 3, dtype=np.int32)
    d = np.array([0.3, -0.5, 0.81]) / np.linalg.norm([0.3, -0.5, 0.81])
    d_p = np.array([0.32, -0.48, 0.8]) / np.linalg.norm([0.32, -0.48, 0.8])
    res = []
    for dev in (cuda, torch.device("cpu")):
        g = SparseGrid.from_numpy(a32, device=dev)
        g.background_data.requires_grad_(True)
        g.sh_data.requires_grad_(True)
        l_bg = TR.background_tv_loss(g, torch.as_tensor(cells_bg, device=dev), 0.3, 0.05)
        l_lum = TR.lumisphere_tv_at(g, torch.as_tensor(cells, device=dev), d, d_p)
        gb, gs = torch.autograd.grad(l_bg + l_lum, [g.background_data, g.sh_data])
        res.append([float(l_bg), float(l_lum), gb.cpu().numpy(), gs.cpu().numpy()])
    for got, ref in zip(*res):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
