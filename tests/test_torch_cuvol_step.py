"""Three steps of the port's make_cuvol_step (the Plenoxels warm start)
against the JAX package's, in float64 on the CPU, from the same grid, rms
state and regularizer windows."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.losses import reg as j_reg
from alphasurf_tpu.render.cuvol import density_occupancy as jax_density_occupancy
from alphasurf_tpu.train import steps as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as t_reg
from alphasurf_torch.render.cuvol import density_occupancy_words
from alphasurf_torch.train import steps as T
from test_torch_util import jax_to_np, np_rays, t64

# the Config defaults of the warm start (config.py:87,104,139,142), with
# larger TV weights so that both regularizers move the rows
HP = dict(lr_sigma=3e1, lr_sh=1e-2, lambda_tv=1e-3, lambda_tv_sh=1e-2)
B = 48


@functools.lru_cache(maxsize=None)
def _jax_step(opt_kw):
    cfg = J.StepConfig(opt=at.RenderOptions(**dict(opt_kw)), renderer="packed",
                       entries_per_ray=64.0)
    return J.make_cuvol_step(cfg)


def _jax_starts(key, grid, cfg, present: bool):
    """The window starts JAX's cuvol step draws from ``key``
    (steps.py:459, reg.py:58 and 97-99)."""
    keys = jax.random.split(key, 5)
    n = grid.capacity if present else grid.links.numel()
    out = {}
    for name, k, frac in zip(T.CUVOL_WINDOWS, keys, (cfg.tv_sparsity, cfg.tv_sh_sparsity)):
        K = max(1, min(n, int(frac * n)))
        out[name] = int(jax.random.randint(k, (), 0, n - K + 1, dtype=jnp.int32))
    return out


def _grid(reso=12, seed=3):
    """A sphere-bounded warm-start grid with a blobby density (negative in
    places, so that the occupancy and the relu both cut) and random SH."""
    rng = np.random.default_rng(seed)
    g = jax_create_grid(reso, basis_dim=4, use_sphere_bound=True, dtype=jnp.float64)
    links = np.asarray(g.links).reshape(-1)
    coords = np.stack(np.meshgrid(*[np.arange(reso)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = np.linalg.norm(coords - reso / 2.0, axis=-1)
    dens = np.maximum(0.0, 3.0 - np.abs(r - reso / 4.0)) + rng.standard_normal(r.shape) * 0.3
    return g.replace(density_data=jnp.asarray(dens[links >= 0, None]),
                     sh_data=jnp.asarray(rng.standard_normal((g.capacity, 12)) * 0.2))


# (render options, windows over present cells): the box and sphere clips,
# last_sample_opaque on the box (the sphere-bounded grid is empty at the
# box's last sample; under the sphere clip the last sample is opaque inside
# the density, and the JAX renderer's chunk-wide prefix then cancels at
# ulp(1e9) ~ 1e-7 in float64, see test_torch_cuvol._per_ray_jax)
CASES = [
    ((("near_clip", 0.05),), True),
    ((("near_clip", 0.05),), False),
    ((("near_clip", 0.0), ("use_spheric_clip", True)), True),
    ((("near_clip", 0.0), ("last_sample_opaque", True)), True),
]


@pytest.mark.parametrize("opt_kw,present", CASES,
                         ids=["box", "box_lattice_cells", "sphere", "box_lso"])
def test_three_cuvol_steps_match_jax(opt_kw, present):
    gj = _grid()
    a = jax_to_np(gj)
    o, d = np_rays(B, seed=4)
    gt = np.random.default_rng(5).uniform(0, 1, (B, 3))
    step_j = _jax_step(opt_kw)
    rms_j = J.init_rms(gj)
    rc_j = j_reg.row_coords_of(gj) if present else None

    cfg = T.StepConfig(opt=pt.RenderOptions(**dict(opt_kw)), renderer="packed")
    g = SparseGrid.from_numpy(a, device="cpu")
    rms = T.init_rms(g)
    assert set(rms) == {"density", "sh"} == set(rms_j)
    rc = t_reg.row_coords_of(g) if present else None
    step = T.make_cuvol_step(cfg)
    rays = pt.Rays(t64(o), t64(d))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        occ_j = jax_density_occupancy(gj)
        gj, rms_j, sj = step_j(gj, rms_j, at.Rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(gt), J.HParams(**HP), key, occ=occ_j, row_coords=rc_j)
        g, rms, st = step(g, rms, rays, t64(gt), T.HParams(**HP), gen,
                          occ=density_occupancy_words(g), row_coords=rc,
                          window_starts=_jax_starts(key, g, cfg, present))
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-8, err_msg=f"{i} {k}")
        assert int(sj["pool_overflow"]) == 0 and int(st["pool_overflow"]) == 0
    for f in ("density_data", "sh_data"):
        got = getattr(g, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(gj, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
        assert np.abs(got - a[f]).max() > 1e-3, f
    got_rms = T.rms_to_numpy(rms)
    for k, v in rms_j.items():
        np.testing.assert_allclose(got_rms[k], np.asarray(v.rms), rtol=1e-8, atol=1e-20,
                                   err_msg=f"rms {k}")


def test_cuvol_step_unported_options_raise():
    """Only the data-parallel cuvol step raises: the dense and compact
    renderers build, and a step without occupancy words trains through the
    dense march (the rows move, the loss is finite)."""
    opt = pt.RenderOptions()
    for renderer in ("dense", "compact", "packed"):
        with pytest.raises(NotImplementedError):
            T.make_cuvol_step(T.StepConfig(opt=opt, renderer=renderer, axis_name="data"))
        assert callable(T.make_cuvol_step(T.StepConfig(opt=opt, renderer=renderer)))
    # the lumisphere TV (K12e) and the learned basis's groups are ported
    assert callable(T.make_cuvol_step(T.StepConfig(opt=opt, use_lumisphere_tv=True)))
    T._check_rms({"density": None, "sh": None, "basis_mlp": None})
    with pytest.raises(ValueError, match="unknown rms groups"):
        T._check_rms({"density": None, "sh": None, "mlp": None})
    g = SparseGrid.from_numpy(jax_to_np(_grid(8)), device="cpu")
    before = g.density_data.detach().clone()
    o, d = np_rays(8, seed=4)
    step = T.make_cuvol_step(T.StepConfig(opt=opt))
    g, _, st = step(g, T.init_rms(g), pt.Rays(t64(o), t64(d)), t64(np.zeros((8, 3))),
                    T.HParams(**HP), torch.Generator().manual_seed(0))
    assert np.isfinite(float(st["loss"])) and bool((g.density_data != before).any())


def test_bench_step_cuvol_runs_on_the_cpu():
    """The warm-start bench (app/bench_step.py --stage cuvol) end to end at
    a tiny size."""
    from alphasurf_torch.app import bench_step

    out = bench_step.main(["--stage", "cuvol", "--reso", "16", "--batch", "256", "--steps", "2",
                           "--width", "64", "--device", "cpu"])
    assert out["stage"] == "cuvol" and out["rays_per_s_fwd_bwd"] > 0
    assert out["first_loss"] < 0.24 and out["losses_finite"] and out["rows_moved"] > 0
    assert out["card"] == "cpu" and out["capacity"] > 0
