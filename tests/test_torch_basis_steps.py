"""Both train steps with a learned basis (a 3D texture or an MLP) against
the JAX package's, in float64 on the CPU: three steps from the same grid,
rms state and windows, at ``lr_basis`` and ``lambda_tv_basis`` 1e-2 (the
JAX package's tests/test_steps_ext.py values), and the Trainer resumed from
a checkpoint that holds a texture, as JAX's Trainer resumes it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.losses import reg as JR
from alphasurf_tpu.render.cuvol import density_occupancy as jax_density_occupancy
from alphasurf_tpu.train import steps as J
from alphasurf_tpu.utils import io as JIO
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as TR
from alphasurf_torch.render.cuvol import density_occupancy_words
from alphasurf_torch.train import steps as T
from alphasurf_torch.utils import io as TIO
from test_torch_basis import DEAD, MLP_KEYS, basis_arrays, basis_params, jax_basis_grid
from test_torch_util import jax_to_np, np_grid, np_rays, t64

BASIS_HP = dict(lr_basis=1e-2, lambda_tv_basis=1e-2)
B = 48


def _jax_rms(rms_j: dict) -> dict:
    """numpy arrays of a JAX rms state, its "basis_mlp" a dict."""
    return {k: ({kk: np.asarray(s.rms) for kk, s in v.items()} if isinstance(v, dict)
                else np.asarray(v.rms)) for k, v in rms_j.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(kind):
    import test_torch_cuvol_step as C
    import test_torch_step as S

    if kind == "surface":
        return J.make_surface_step(J.StepConfig(opt=at.RenderOptions(**S.OPT),
                                                entries_per_ray=48, cache_size=None))
    return J.make_cuvol_step(J.StepConfig(opt=at.RenderOptions(near_clip=0.05),
                                          renderer="packed", entries_per_ray=64.0))


@pytest.mark.parametrize("basis", ["texture", "mlp"])
@pytest.mark.parametrize("kind", ["surface", "cuvol"])
def test_three_steps_train_the_basis_like_jax(kind, basis):
    """Three steps of each package from the same rms state (the basis's
    groups start at seeded non-zero values, as after earlier steps): loss
    and mse each step, then every trained array (the basis's among them)
    and its rms state to rtol 1e-8; the basis moved. The MLP's hidden unit
    DEAD never fires, so its b0 entry takes no gradient: the bias masks as
    one row, so that entry's rms state decays by rms_beta a step, as JAX's
    (a per-element mask would keep it)."""
    import test_torch_cuvol_step as C
    import test_torch_step as S

    if kind == "surface":
        a = basis_arrays(np_grid(12, seed=3, prune=0.1, basis_dim=4), basis)
        hp = {**S.HP, **BASIS_HP}
        cfg = T.StepConfig(opt=pt.RenderOptions(**S.OPT), cache_size=None)
        fields = ("density_data", "sh_data", "surface_data", "fake_sample_std")
    else:
        a = basis_arrays(jax_to_np(C._grid()), basis)
        hp = {**C.HP, **BASIS_HP}
        cfg = T.StepConfig(opt=pt.RenderOptions(near_clip=0.05), renderer="packed")
        fields = ("density_data", "sh_data")
    gj = jax_basis_grid(a)
    step_j = _jax_step(kind)
    rms_j = J.init_rms(gj)
    rc_j = JR.row_coords_of(gj)
    rng = np.random.default_rng(9)
    r0 = {}
    for k, v in list(rms_j.items()):
        if k == "basis_data":
            r0[k] = rng.uniform(1e-6, 1e-4, v.rms.shape)
            rms_j[k] = J.RMSState(rms=jnp.asarray(r0[k]))
        elif k == "basis_mlp":
            r0[k] = {kk: rng.uniform(1e-6, 1e-4, s.rms.shape) for kk, s in v.items()}
            rms_j[k] = {kk: J.RMSState(rms=jnp.asarray(x)) for kk, x in r0[k].items()}
    g = SparseGrid.from_numpy(a, device="cpu")
    rms = T.init_rms(g)
    assert set(rms) == set(rms_j)
    rms.update(T.rms_from_numpy(r0, device="cpu", dtype=torch.float64))
    rc = TR.row_coords_of(g)
    step = (T.make_surface_step if kind == "surface" else T.make_cuvol_step)(cfg)
    o, d = np_rays(B, seed=4)
    gt = np.random.default_rng(5).uniform(0, 1, (B, 3))
    rays = pt.Rays(t64(o), t64(d))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        kw_j, kw_t = {}, {}
        if kind == "cuvol":
            kw_j["occ"], kw_t["occ"] = jax_density_occupancy(gj), density_occupancy_words(g)
            starts = C._jax_starts(key, g, cfg, True)
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
    ref = ({"basis_data": gj.basis_data} if basis == "texture"
           else {f"basis_mlp.{k}": gj.basis_mlp[k] for k in MLP_KEYS})
    start = basis_params(SparseGrid.from_numpy(a, device="cpu"))
    for k, v in basis_params(g).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
        if k != "basis_mlp.b0":
            assert np.abs(v.detach().numpy() - start[k].numpy()).max() > 1e-6, k
    # rms states to rtol 1e-8, with a floor of 1e-10 of each array's largest
    # value: the MLP's two matrix products are summed in another order by
    # XLA than by PyTorch (1e-16 apart in float64), and three warm-start
    # steps at lr_sigma 30 (density rows move by ~100 a step) carry that to
    # the cancellation residues of the density gradient (4.5e-19 against a
    # largest rms of 2.9e-8 on the cuvol step with the MLP)
    got_rms, want_rms = T.rms_to_numpy(rms), _jax_rms(rms_j)
    for k, v in want_rms.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            got = got_rms[k] if kk is None else got_rms[k][kk]
            np.testing.assert_allclose(got, vv, rtol=1e-8, atol=1e-10 * np.abs(vv).max() + 1e-30,
                                       err_msg=f"rms {k} {kk}")
    if basis == "mlp":
        # the dead unit's bias entry took no gradient, yet its rms state was
        # stepped with the row: decayed by rms_beta three times
        b0, b0_start = got_rms["basis_mlp"]["b0"], r0["basis_mlp"]["b0"]
        np.testing.assert_allclose(b0[DEAD], b0_start[DEAD] * cfg.rms_beta ** 3, rtol=1e-12)
    else:
        # a texture cell without gradient keeps its rms state
        untouched = np.all(np.asarray(rms_j["basis_data"].rms) == r0["basis_data"], axis=-1)
        assert untouched.any() and not untouched.all()


def test_trainer_resumed_with_a_texture_matches_jax(tmp_path, monkeypatch):
    """Both Trainers resume from one checkpoint that holds a 3D-texture
    basis and take four warm-start steps, float64 (JAX's load_grid given
    dtype float64): each step's mse, the rows, the texture (its lr_basis is
    0 in both Trainers, so it stays) and its rms state, and the eval PSNR,
    rtol 1e-8; the port's saved checkpoint holds the texture."""
    from alphasurf_tpu.app import config as JCfg
    from alphasurf_tpu.core.grid import create_grid as jax_create_grid
    from alphasurf_tpu.train import trainer as JT
    from alphasurf_torch.app import config as TCfg
    from alphasurf_torch.train import trainer as TT
    from test_torch_trainer import RUN, _datasets, _port_copy, _record_mse

    jd, jd_test = _datasets()
    a = basis_arrays(jax_to_np(jax_create_grid(16, basis_dim=4, init_sigma=0.3,
                                               dtype=jnp.float32)), "texture")
    a["sh_data"] = np.random.default_rng(2).standard_normal(a["sh_data"].shape) * 0.2
    gj = jax_basis_grid(a, jnp.float32)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        JIO.save_grid(gj, str(tmp_path / name / "ckpt.npz"))
    monkeypatch.setattr(JT, "load_grid", functools.partial(JIO.load_grid, dtype=jnp.float64))
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)
    run = dict(RUN, n_iters=4, eval_every_iter=0, load_ckpt=True)
    tj = JT.Trainer(JCfg.apply_dict(JCfg.Config(), dict(run, train_dir=str(tmp_path / "jax"))),
                    jd, jd_test)
    tj.mse_trace = []
    psnr_j = tj.train()
    tt = TT.Trainer(TCfg.apply_dict(TCfg.Config(), dict(run, train_dir=str(tmp_path / "port"))),
                    _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    assert tt.grid.basis_data is not None and "basis_data" in tt.rms
    tt.mse_trace = []
    psnr_t = tt.train()
    assert len(tt.mse_trace) == len(tj.mse_trace) == 4
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    for f in ("density_data", "sh_data", "basis_data"):
        np.testing.assert_allclose(getattr(tt.grid, f).detach().numpy(),
                                   np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_array_equal(tt.grid.basis_data.detach().numpy(),
                                  np.asarray(gj.basis_data, np.float64))
    rms_b = tt.rms["basis_data"].numpy()
    assert np.abs(rms_b).max() > 0
    np.testing.assert_allclose(rms_b, np.asarray(tj.rms["basis_data"].rms), rtol=1e-8,
                               atol=1e-20)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-8)
    saved, _ = TIO.load_grid(str(tmp_path / "port" / "ckpt.npz"), device="cpu")
    np.testing.assert_array_equal(saved.basis_data.numpy(), np.asarray(gj.basis_data))
    assert saved.basis_type == a["basis_type"]


def test_bench_step_with_a_learned_basis_runs_on_the_cpu():
    """bench_step --basis end to end at a tiny size: finite losses, and the
    texture's rows moved (through its TV too)."""
    from alphasurf_torch.app import bench_step

    out = bench_step.main(["--basis", "texture", "--reso", "16", "--batch", "256", "--steps", "2",
                           "--width", "64", "--device", "cpu"])
    assert out["basis"] == "texture" and out["losses_finite"]
    assert out["rows_moved"] > 0 and out["basis_moved"] > 0
    with pytest.raises(ValueError, match="basis must be one of"):
        bench_step.with_basis(bench_step.build_cuvol_grid(8, "cpu")[0], "wavelet")
