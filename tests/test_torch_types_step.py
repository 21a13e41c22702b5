"""The surface step and the Trainer on the other surface types against the
JAX package, float64 on the CPU: three steps of ``make_surface_step`` per
type (the JAX trainability test's configuration: packed renderer, its
HParams, with the udf-var loss and a trainable fake_sample_std added) and
a Trainer run with ``surface_type = udf`` through the warm start and the
density -> surface transition (``train_udf.sh``'s shape)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu import defs
from alphasurf_tpu.losses import reg as j_reg
from alphasurf_tpu.train import steps as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as t_reg
from alphasurf_torch.render import surface as TS
from alphasurf_torch.train import steps as T
from test_torch_types import CASES, type_arrays, type_rays
from test_torch_util import jax_grid, t64

STEP_TYPES = ("plane", "udf", "udf_alpha", "udf_fake_sample", "voxel_face")


def _hp(name: str) -> dict:
    """The trainability test's HParams (PLANE's surface rate 0: its
    root-snapping landscape oscillates under RMSprop at this size), plus
    lambda_udf_var and lr_fake_sample_std, so that both reach the step."""
    lr_surf = 0.0 if name == "plane" else 1e-3
    return dict(lr_alpha=1e-2, lr_surface=lr_surf, lr_sh=1e-2, lambda_tv_alpha=1e-6,
                lambda_tv_surface=1e-6, lambda_udf_var=1e-2, lr_fake_sample_std=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_step(name: str):
    opt = at.RenderOptions(sigma_thresh=-1e9, stop_thresh=1e-7, **CASES[name][2])
    return J.make_surface_step(J.StepConfig(opt=opt, cache_size=None, renderer="packed",
                                            entries_per_ray=32.0))


def _jax_starts(key, cap, cfg):
    """The present-cell window starts JAX's step draws from ``key``
    (steps.py:229, reg.py:97-99)."""
    keys = jax.random.split(key, 9)
    fracs = (cfg.tv_sparsity, cfg.tv_sh_sparsity, cfg.tv_surface_sparsity,
             cfg.norm_surface_sparsity, cfg.sparsify_sparsity, cfg.norm_surface_sparsity)
    out = {}
    for w, k, frac in zip(T.WINDOWS, keys, fracs):
        K = max(1, min(cap, int(frac * cap)))
        out[w] = int(jax.random.randint(k, (), 0, cap - K + 1, dtype=jnp.int32))
    return out


@pytest.mark.parametrize("name", STEP_TYPES)
def test_three_steps_match_jax(name):
    """Three steps from the same grid, rms state and windows: loss and mse
    each step, then every trained array (UDF_ALPHA's (n_lv, 1) alpha table
    among them, stepped by K7 as one group) and its rms state, rtol 1e-8
    (atol 1e-12 on the rows, 1e-20 on the rms states, whose smallest
    entries are the squares of gradients that cancel). The rows moved."""
    a = type_arrays(name, seed=1)
    o, d = type_rays()
    gt = np.random.default_rng(5).uniform(0, 1, (o.shape[0], 3))
    hp = _hp(name)
    gj = jax_grid(a)
    rms_j = J.init_rms(gj)
    rc_j = j_reg.row_coords_of(gj)
    step_j = _jax_step(name)
    opt = pt.RenderOptions(sigma_thresh=-1e9, stop_thresh=1e-7, **CASES[name][2])
    cfg = T.StepConfig(opt=opt, cache_size=None, renderer="packed")
    g = SparseGrid.from_numpy(a, device="cpu")
    rms = T.rms_from_numpy({k: np.asarray(v.rms) for k, v in rms_j.items()}, device="cpu")
    assert set(rms) == set(T.init_rms(g))
    rc = t_reg.row_coords_of(g)
    step = T.make_surface_step(cfg)
    rays = pt.Rays(t64(o), t64(d))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        gj, rms_j, sj = step_j(gj, rms_j, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(gt), J.HParams(**hp), key, row_coords=rc_j)
        g, rms, st = step(g, rms, rays, t64(gt), T.HParams(**hp), gen, row_coords=rc,
                          window_starts=_jax_starts(key, g.capacity, cfg))
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-8, err_msg=f"{i} {k}")
    for f in ("density_data", "sh_data", "surface_data", "fake_sample_std"):
        got = getattr(g, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(gj, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    assert np.abs(g.sh_data.detach().numpy() - a["sh_data"]).max() > 1e-3
    assert np.abs(g.density_data.detach().numpy() - a["density_data"]).max() > 1e-3
    got_rms = T.rms_to_numpy(rms)
    for k, v in rms_j.items():
        np.testing.assert_allclose(got_rms[k], np.asarray(v.rms), rtol=1e-8, atol=1e-20,
                                   err_msg=f"rms {k}")
    if CASES[name][0] == defs.SURFACE_TYPE_UDF_ALPHA:
        assert g.density_data.shape == (1, 1)


def test_udf_trainer_run_matches_jax(tmp_path, monkeypatch):
    """Both Trainers with ``surface_type = udf``: a warm start at 8^3, the
    density resample and init_surface_from_density at step 4 (then the grid
    becomes a UDF grid, as JAX's ``grid.replace(surface_type=...)``), four
    UDF steps with the udf-var loss; float64 grids, the JAX Trainer in host
    mode on its device transitions (as in test_torch_trainer).
    The init's surface and level set are (density - zero_lv_density) and
    (0.5 - zero_lv_density) over the field's mean gradient norm: at the
    default zero level (0.5, the one density level) the level set is 0,
    which no softplus of a UDF value reaches; zero_lv_density -6 puts it
    within the softplus values of this run (55 voxels occupied). Every
    step's mse and the final rows to rtol 1e-8, the eval PSNR to rtol 1e-6
    (both render it in float32); the UDF grid has occupied voxels."""
    from alphasurf_tpu.app import config as JCfg
    from alphasurf_tpu.core import topology as JTopo
    from alphasurf_tpu.core.grid import create_grid as jax_create_grid
    from alphasurf_tpu.train import trainer as JT
    from alphasurf_torch.app import config as TCfg
    from alphasurf_torch.train import trainer as TT
    from test_torch_trainer import STAGES, _datasets, _port_copy, _record_mse

    run = dict(STAGES, reso=[[8, 8, 8], [8, 8, 8]], n_iters=8, surface_type="udf",
               lambda_udf_var_loss=1e-2, zero_lv_density=-6.0)
    jd, jd_test = _datasets()
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    monkeypatch.setattr(JTopo, "_DEVICE_DISPATCH_SIZE", 1)
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)
    tj = JT.Trainer(JCfg.apply_dict(JCfg.Config(), dict(run, train_dir=str(tmp_path / "j"))),
                    jd, jd_test)
    tj.mse_trace = []
    psnr_j = tj.train()
    tt = TT.Trainer(TCfg.apply_dict(TCfg.Config(), dict(run, train_dir=str(tmp_path / "t"))),
                    _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    psnr_t = tt.train()
    assert [r["kind"] for r in tt.transitions] == ["upsample", "init_surface_from_density"]
    assert tt.grid.surface_type == tj.grid.surface_type == defs.SURFACE_TYPE_UDF
    assert len(tt.mse_trace) == len(tj.mse_trace) == 8
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    for f in ("density_data", "sh_data", "surface_data"):
        np.testing.assert_allclose(getattr(tt.grid, f).detach().numpy(),
                                   np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-6)
    assert float(tt.grid.level_set_data.min()) > 0
    assert bool(TS.voxel_occupancy(tt.grid, pt.RenderOptions(sigma_thresh=-1e9)).any())


def test_plane_trainer_from_create_grid_matches_jax(tmp_path, monkeypatch):
    """A Trainer run with ``surface_type = plane`` and
    ``no_surface_init_iters = 0``: both Trainers build the PLANE grid through
    create_grid (its random planes, 4 surface channels, bit for bit) and
    train it for four steps; float64, each step's mse and the final rows to
    rtol 1e-8. The sampled TV weights are 0, as in test_torch_trainer (the
    packages draw their windows differently)."""
    from alphasurf_tpu.app import config as JCfg
    from alphasurf_tpu.core.grid import create_grid as jax_create_grid
    from alphasurf_tpu.train import trainer as JT
    from alphasurf_torch.app import config as TCfg
    from alphasurf_torch.train import trainer as TT
    from test_torch_trainer import RUN, _datasets, _port_copy, _record_mse

    run = dict(RUN, reso=[[8, 8, 8]], n_iters=4, surface_type="plane", no_surface_init_iters=0,
               eval_every_iter=0, sigma_thresh=-1.0e9, lr_surface=1e-3, lambda_tv_alpha=0.0)
    jd, jd_test = _datasets()
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)
    tj = JT.Trainer(JCfg.apply_dict(JCfg.Config(), dict(run, train_dir=str(tmp_path / "j"))),
                    jd, jd_test)
    tj.mse_trace = []
    tj.train()
    tt = TT.Trainer(TCfg.apply_dict(TCfg.Config(), dict(run, train_dir=str(tmp_path / "t"))),
                    _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    tt.train()
    assert tt.grid.surface_type == tj.grid.surface_type == defs.SURFACE_TYPE_PLANE
    assert tt.grid.surface_data.shape[1] == 4
    assert len(tt.mse_trace) == len(tj.mse_trace) == 4
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    for f in ("density_data", "sh_data", "surface_data"):
        np.testing.assert_allclose(getattr(tt.grid, f).detach().numpy(),
                                   np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
