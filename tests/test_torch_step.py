"""Three steps of the port's make_surface_step against the JAX package's, in
float64 on the CPU, from the same grid, rms state and regularizer windows."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import reg as j_reg
from alphasurf_tpu.train import steps as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as t_reg
from alphasurf_torch.train import steps as T
from test_torch_util import jax_grid, np_grid, np_rays, t64

OPT = dict(sigma_thresh=-1e9, stop_thresh=1e-7, only_outward_intersect=True,
           surf_fake_sample=True, limited_fake_sample=True, truncated_vol_render=True)
# bench.py's weights, plus small ones on the other terms so that each is
# differentiated and fake_sample_std trains
HP = dict(lr_alpha=1e-3, lr_surface=1e-5, lr_sh=1e-3, lr_fake_sample_std=1e-4,
          lambda_tv_alpha=1e-5, lambda_tv_surface=1e-3, lambda_normal_l1=1e-6,
          lambda_l_entropy=1e-4, lambda_tv_sh=1e-5, lambda_normal_l2=1e-5,
          lambda_sparsify_alpha=1e-5, lambda_sparsify_surf=1e-5, lambda_l_dist=1e-4,
          lambda_l_dist_a=1e-4, lambda_l_entropy_a=1e-4, lambda_sparsity=1e-6,
          lambda_inward_norm=1e-4, lambda_density_lap=1e-4, lambda_fs_std_l1=1e-3,
          lambda_fs_std_l2=1e-3, img_lambda_l1_ratio=0.1)
B = 48


# the renderer choices of StepConfig: (renderer, use_two_pass_losses); the
# compact renderer at a K that truncates some rays of the batch
RENDER_CFGS = {
    "packed": dict(renderer="packed"),
    "compact": dict(renderer="compact", max_intersect_voxels=3, voxel_chunk=2),
    "dense": dict(renderer="dense"),
    "packed_two_pass": dict(renderer="packed", use_two_pass_losses=True, cache_size=6),
    "compact_two_pass": dict(renderer="compact", use_two_pass_losses=True, cache_size=64),
    "dense_two_pass": dict(renderer="dense", use_two_pass_losses=True, cache_size=4),
}
TWO_PASS_HP = dict(lambda_conv_mode_samp=1e-3, lambda_samp_dist=1e-3)


# the extended surface regularizers (K12a-K12d): flag -> its weight
EXT_HP = {"use_eikonal": dict(lambda_eikonal=1e-3), "use_norm_match": dict(lambda_norm_match=1e-3),
          "use_viscosity": dict(lambda_viscosity=1e-3),
          "use_sign_change": dict(lambda_sign_change=1e-2)}


@functools.lru_cache(maxsize=None)
def _jax_step(surf_grad_abs_max, render="packed", ext=()):
    cfg = J.StepConfig(opt=at.RenderOptions(**OPT), entries_per_ray=48,
                       surf_grad_abs_max=surf_grad_abs_max, **{"cache_size": None,
                                                               **RENDER_CFGS[render]},
                       **dict.fromkeys(ext, True))
    return J.make_surface_step(cfg)


def _jax_starts(key, cap, cfg):
    """The window starts JAX's step draws from ``key`` (steps.py:229,
    reg.py:97-99); its k_ext (steps.py:348) is the "sign_change" window."""
    keys = jax.random.split(key, 9)
    fracs = (cfg.tv_sparsity, cfg.tv_sh_sparsity, cfg.tv_surface_sparsity,
             cfg.norm_surface_sparsity, cfg.sparsify_sparsity, cfg.norm_surface_sparsity)
    out = {}
    for name, k, frac in zip(T.WINDOWS, keys, fracs):
        K = max(1, min(cap, int(frac * cap)))
        out[name] = int(jax.random.randint(k, (), 0, cap - K + 1, dtype=jnp.int32))
    return out


def _run(hp_kw, surf_grad_abs_max=None, n_steps=3, render="packed", ext=()):
    a = np_grid(12, seed=3, prune=0.1)
    o, d = np_rays(B, seed=4)
    gt = np.random.default_rng(5).uniform(0, 1, (B, 3))
    hp = {**HP, **hp_kw}

    gj = jax_grid(a)
    rms_j = J.init_rms(gj)
    rc_j = j_reg.row_coords_of(gj)
    step_j = _jax_step(surf_grad_abs_max, render, ext)

    cfg = T.StepConfig(opt=pt.RenderOptions(**OPT), surf_grad_abs_max=surf_grad_abs_max,
                       **{"cache_size": None, **RENDER_CFGS[render]}, **dict.fromkeys(ext, True))
    g = SparseGrid.from_numpy(a, device="cpu")
    rms = T.rms_from_numpy({k: np.asarray(v.rms) for k, v in rms_j.items()}, device="cpu")
    rc = t_reg.row_coords_of(g)
    step = T.make_surface_step(cfg)
    rays = pt.Rays(t64(o), t64(d))
    gen = torch.Generator().manual_seed(0)
    for i in range(n_steps):
        key = jax.random.PRNGKey(i)
        gj, rms_j, sj = step_j(gj, rms_j, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(gt), J.HParams(**hp), key, row_coords=rc_j)
        g, rms, st = step(g, rms, rays, t64(gt), T.HParams(**hp), gen, row_coords=rc,
                          window_starts=_jax_starts(key, g.capacity, cfg))
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-8, err_msg=f"{i} {k}")
        assert int(sj["pool_overflow"]) == 0 and int(st["pool_overflow"]) == 0
    for f in ("density_data", "sh_data", "surface_data", "fake_sample_std"):
        np.testing.assert_allclose(getattr(g, f).detach().numpy(), np.asarray(getattr(gj, f)),
                                   rtol=1e-8, atol=1e-12, err_msg=f)
    got_rms = T.rms_to_numpy(rms)
    for k, v in rms_j.items():
        np.testing.assert_allclose(got_rms[k], np.asarray(v.rms), rtol=1e-8, atol=1e-20,
                                   err_msg=f"rms {k}")
    return a, g


def test_three_steps_match_jax():
    a, g = _run({})
    for f in ("density_data", "sh_data", "surface_data", "fake_sample_std"):
        assert np.abs(getattr(g, f).detach().numpy() - a[f]).max() > 0, f


def test_surf_grad_abs_max_clips_like_jax():
    a, g = _run({}, surf_grad_abs_max=1e-6)
    assert np.abs(g.surface_data.detach().numpy() - a["surface_data"]).max() > 0


def test_frozen_surface_stays_like_jax():
    a, g = _run({"surface_unfrozen": 0.0}, n_steps=2)
    np.testing.assert_array_equal(g.surface_data.detach().numpy(), a["surface_data"])


@pytest.mark.parametrize("render", ["compact", "dense", "packed_two_pass", "compact_two_pass",
                                    "dense_two_pass"])
def test_renderer_steps_match_jax(render):
    """Two steps through each renderer, with and without the two-pass
    losses on the first-K cache, against JAX's step: loss, mse, rows and rms
    state to rtol 1e-8."""
    hp = TWO_PASS_HP if render.endswith("two_pass") else {}
    a, g = _run(hp, n_steps=2, render=render)
    assert np.abs(g.surface_data.detach().numpy() - a["surface_data"]).max() > 0


@pytest.mark.parametrize("flag", sorted(EXT_HP))
def test_extended_regularizer_steps_match_jax(flag):
    """Three steps with one extended surface regularizer on (K12a-K12d
    through their plain versions) against JAX's step, its k_ext window
    for the sign change: loss, mse, rows and rms state to rtol 1e-8; the
    term is not 0 on the grid's rows."""
    _, g = _run(EXT_HP[flag], ext=(flag,))
    cells = t_reg.sample_present_cells(None, g, t_reg.row_coords_of(g), 1.0, start=0)
    term = {"use_eikonal": t_reg.surface_eikonal_loss,
            "use_norm_match": t_reg.surface_norm_match_loss,
            "use_viscosity": t_reg.surface_viscosity_loss,
            "use_sign_change": t_reg.surface_sign_change_loss}[flag]
    assert float(term(g, cells)) != 0.0


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("flags", [(), ("use_eikonal",), tuple(sorted(EXT_HP))])
def test_window_draws_keep_their_sequence(dense, flags, monkeypatch):
    """The windows a step draws from its generator, in order: with the
    extended flags off, those of the steps before them (the dense branch
    draws no "normal" window); with one on, the "normal" window in the
    dense branch too, and "sign_change" after "sparsify" with
    use_sign_change."""
    a = np_grid(8, seed=3, prune=0.1)
    g = SparseGrid.from_numpy(a, device="cpu")
    rc = t_reg.row_coords_of(g)
    fracs = dict(tv=0.01, tv_sh=0.02, tv_surface=1.0 if dense else 0.03,
                 normal=1.0 if dense else 0.04, sparsify=0.05)
    cfg = T.StepConfig(opt=pt.RenderOptions(**OPT), cache_size=None, tv_sparsity=fracs["tv"],
                       tv_sh_sparsity=fracs["tv_sh"], tv_surface_sparsity=fracs["tv_surface"],
                       norm_surface_sparsity=fracs["normal"], sparsify_sparsity=fracs["sparsify"],
                       **dict.fromkeys(flags, True))
    drawn = []
    orig = t_reg._window_start

    def record(generator, n_starts, start):
        drawn.append(n_starts)
        return orig(generator, n_starts, start)

    monkeypatch.setattr(t_reg, "_window_start", record)
    o, d = np_rays(8, seed=4)
    T.make_surface_step(cfg)(g, T.init_rms(g), pt.Rays(t64(o), t64(d)), t64(np.zeros((8, 3))),
                             T.HParams(**HP), torch.Generator().manual_seed(0), row_coords=rc)
    cap = g.capacity

    def n_starts(name):
        return cap - max(1, min(cap, int(fracs[name] * cap))) + 1

    names = ["tv", "tv_sh"] + ([] if dense else ["tv_surface", "normal"])
    if dense and flags:
        names.append("normal")
    names.append("sparsify")
    if "use_sign_change" in flags:
        names.append("normal")  # the sign-change window takes norm_surface_sparsity
    assert drawn == [n_starts(k) for k in names]


def test_unported_options_raise():
    """Data-parallel steps still raise, naming their ROADMAP item, the cuvol
    step's too. The lumisphere TV (K12e), the learned basis's rms groups and
    a cuvol step on the dense march (renderer "dense") no longer raise; a
    group no package has does."""
    opt = pt.RenderOptions(**OPT)
    for kw in (dict(use_lumisphere_tv=True), dict(use_lumisphere_tv=True, use_eikonal=True)):
        assert callable(T.make_surface_step(T.StepConfig(opt=opt, **kw)))
    with pytest.raises(NotImplementedError, match="§1 item 3"):
        T.make_surface_step(T.StepConfig(opt=opt, axis_name="data"))
    for group in ("basis_data", "basis_mlp"):
        T._check_rms({"density": None, "background": None, group: None})
    with pytest.raises(ValueError, match="unknown rms groups"):
        T._check_rms({"density": None, "basis": None})
    assert callable(T.make_cuvol_step(T.StepConfig(opt=opt, renderer="dense")))
    with pytest.raises(NotImplementedError, match="§1 item 3"):
        T.make_cuvol_step(T.StepConfig(opt=opt, renderer="dense", axis_name="data"))


def test_bench_step_runs_on_the_cpu():
    """The port's bench (app/bench_step.py) end to end at a tiny size."""
    from alphasurf_torch.app import bench_step

    out = bench_step.main(["--reso", "16", "--batch", "256", "--steps", "2", "--width", "64",
                           "--device", "cpu"])
    assert out["metric"] == "rays_per_s_fwd_bwd" and out["rays_per_s_fwd_bwd"] > 0
    assert out["first_loss"] < 0.24 and out["losses_finite"] and out["rows_moved"] > 0
    assert out["card"] == "cpu" and out["capacity"] > 0
