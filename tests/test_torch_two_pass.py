"""The port's Trainer with the compact and dense surface renderers and the
two-pass losses on the first-K sample cache, against the JAX Trainer, on
the CPU."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.app import config as JCfg
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.train import trainer as JT
from alphasurf_torch.app import config as TCfg
from alphasurf_torch.train import trainer as TT
from test_torch_trainer import STAGES, _datasets, _port_copy, _record_mse


@contextlib.contextmanager
def _jax_compile_cache_off():
    """JAX's persistent compilation cache off (tests/conftest.py turns it
    on), restored afterwards. With it on, the Trainer run below failed now
    and then (2 of 16 runs at one commit, 8 of 32 at the next; 5 of 5
    passed with it off), and a failing run had XLA warn that it loaded
    cached CPU executables built for other machine features. The cache is
    read once per process, so it is reset on the way in and out, and the
    executables this process already holds are dropped on the way in, so
    that every program of the run is compiled here. Its later failures
    under pytest-xdist came from elsewhere: test_unported_stages_raise set
    foreground masks on the datasets of test_torch_trainer._datasets (an
    lru_cache shared by every Trainer test of a worker), so when it had run
    first in the same worker, the JAX Trainer here trained with mask
    pruning and the port's copy without; it sets them through monkeypatch
    now (ROADMAP §3)."""
    from jax._src import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        compilation_cache.reset_cache()


@pytest.mark.parametrize("renderer", ["compact", "dense"])
def test_two_pass_trainer_run_matches_jax(tmp_path, monkeypatch, renderer):
    """The warm start and surface stage of
    test_three_stage_trainer_run_matches_jax (its 12^3 upsample left out)
    with the surface stage on the compact or dense renderer and the
    two-pass losses on (lambda_conv_mode_samp and lambda_l_samp_dist > 0,
    so both Trainers set use_two_pass_losses with the first-K cache of 64),
    float64, rtol 1e-8 on every step's mse and the final rows. The dense
    step's occupancy is refreshed every 4 steps by the Trainer, so a stale
    one would show. Both Trainers send the warm start of such a run
    through the dense cuvol march."""
    from alphasurf_tpu.core import topology as JTopo

    jd, jd_test = _datasets()
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    monkeypatch.setattr(JTopo, "_DEVICE_DISPATCH_SIZE", 1)
    seen, seen_cuvol = [], []
    surface_t, cuvol_t = TT.make_surface_step, TT.make_cuvol_step
    monkeypatch.setattr(TT, "make_surface_step", lambda cfg: seen.append(cfg) or surface_t(cfg))
    monkeypatch.setattr(TT, "make_cuvol_step",
                        lambda cfg: seen_cuvol.append(cfg) or cuvol_t(cfg))
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)
    run = dict(STAGES, reso=[[8, 8, 8], [8, 8, 8]], n_iters=8, surface_renderer=renderer,
               lambda_conv_mode_samp=1e-3, lambda_l_samp_dist=1e-3)
    with _jax_compile_cache_off():
        tj = JT.Trainer(JCfg.apply_dict(JCfg.Config(), dict(run, train_dir=str(tmp_path / "j"))),
                        jd, jd_test)
        tj.mse_trace = []
        psnr_j = tj.train()
    tt = TT.Trainer(TCfg.apply_dict(TCfg.Config(), dict(run, train_dir=str(tmp_path / "t"))),
                    _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    psnr_t = tt.train()
    assert seen and all(c.renderer == renderer and c.use_two_pass_losses and c.cache_size == 64
                        for c in seen)
    assert seen_cuvol and all(c.renderer == renderer for c in seen_cuvol)
    assert len(tt.mse_trace) == len(tj.mse_trace) == 8
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    for f in ("density_data", "sh_data", "surface_data"):
        np.testing.assert_allclose(getattr(tt.grid, f).detach().numpy(),
                                   np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-6)
