"""Where the two packages part in float32 on the mini recipe (ROADMAP §3
item 1): in float64 the warm start of both Trainers agrees step for step
(tests/test_torch_trainer.py); in float32 the synthetic dataset's ground
truth and the first step's render already differ, on the rays whose
float32 ray bounds the JAX package's jitted code (XLA on the CPU contracts
o + t d into fused multiply-adds) and the port's eager code disagree on
(ROADMAP §3, "JAX float32 ray bounds"). Two 32x32 views of the synthetic
scene at 16^3 are the smallest size that shows it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.app import config as JCfg
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_tpu.ops import dda as jdda
from alphasurf_tpu.render import cuvol as JC
from alphasurf_torch.app import config as TCfg
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.data.synthetic import SyntheticDataset, make_gt_grid
from alphasurf_torch.ops import dda as tdda
from alphasurf_torch.render import cuvol as TC
from test_torch_util import jax_to_np


def _bounds_apart(gj, g, o, d):
    """The rays whose float32 (tnear, tmax) differ between JAX's jitted
    ray_bounds on grid ``gj`` and the port's on ``g``."""
    bj = jax.jit(lambda o_, d_: jdda.ray_bounds(gj, *jdda.preprocess_rays(gj, o_, d_)[:2]))(
        jnp.asarray(o), jnp.asarray(d))
    ot, dt, _, _ = tdda.preprocess_rays(g, torch.as_tensor(o), torch.as_tensor(d))
    apart = np.zeros(o.shape[0], bool)
    for x, y in zip(bj, tdda.ray_bounds(g, ot, dt)):
        x, y = np.asarray(x, np.float64), y.double().numpy()
        both = np.isfinite(x) & np.isfinite(y)
        apart |= (np.isfinite(x) != np.isfinite(y)) | (np.where(both, np.abs(x - y), 0) > 1e-4)
    return apart


def test_float32_synthetic_ground_truth_differs_only_where_the_ray_bounds_do():
    """The two packages' synthetic datasets (the packed renderer's float32
    ground truth of make_gt_grid(16), two 32x32 views): the pixels that
    differ by more than 1e-3 lie on rays whose bounds JAX's jitted code and
    the port's disagree on; the rest agree to 1e-4. At the mini recipe's
    size (64^3, nine 64x64 views) 1,750 of 36,864 train and 651 of 12,288
    test pixels differ this way, 4.7% and 5.3%: the two packages trained
    and scored on different images."""
    j = JaxSynthetic(split="train", n_images=2, width=32, height=32, reso=16, renderer="packed")
    t = SyntheticDataset(split="train", n_images=2, width=32, height=32, reso=16,
                         renderer="packed", device="cpu")
    np.testing.assert_array_equal(np.asarray(j.c2w), np.asarray(t.c2w))
    diff = np.abs(np.asarray(j.gt).reshape(-1, 3) - np.asarray(t.gt).reshape(-1, 3)).max(-1)
    o = np.asarray(j.rays_init.origins, np.float32)
    d = np.asarray(j.rays_init.dirs, np.float32)
    apart = _bounds_apart(jax_make_gt_grid(16), make_gt_grid(16, device="cpu"), o, d)
    assert (diff > 1e-3).sum() > 0
    assert np.all(apart[diff > 1e-3])
    assert diff[~apart].max() < 1e-4


def test_float32_warm_start_renders_differ_only_where_the_ray_bounds_do():
    """The warm start's packed cuvol render of every ray of two 32x32 views
    at the Config's init (16^3, sphere-bounded, init_sigma 0.1), float32,
    JAX jitted against the port: the rays whose rgb differ by more than
    1e-4 are rays whose bounds (tnear, tmax) differ between JAX's jitted
    ray_bounds and the port's; on every other ray the two agree to 1e-5;
    and the batch mse, equal to 1e-6 of itself without those rays, differs
    by more than 1e-5 of itself with them."""
    jd = JaxSynthetic(split="train", n_images=2, width=32, height=32, reso=64, renderer="packed")
    gj = jax_create_grid(16, basis_dim=9, use_sphere_bound=True, init_sigma=0.1)
    g = SparseGrid.from_numpy(jax_to_np(gj), device="cpu", dtype=torch.float32)
    opt_j = JCfg.render_options_from(JCfg.Config(), no_surface=True)
    opt_t = TCfg.render_options_from(TCfg.Config(), no_surface=True)
    o = np.asarray(jd.rays_init.origins, np.float32)
    d = np.asarray(jd.rays_init.dirs, np.float32)
    gt = np.asarray(jd.rays_init.gt)

    rgb_j = np.asarray(jax.jit(lambda g_, o_, d_: JC.volume_render_cuvol_packed(
        g_, at.Rays(o_, d_), opt_j, entries_per_ray=64.0)["rgb"])(gj, jnp.asarray(o),
                                                                  jnp.asarray(d)))
    rgb_t = TC.volume_render_cuvol_packed(g, pt.Rays(torch.as_tensor(o), torch.as_tensor(d)),
                                          opt_t)["rgb"].numpy()
    apart = _bounds_apart(gj, g, o, d)
    diff = np.abs(rgb_j - rgb_t).max(-1)
    assert (diff > 1e-4).sum() > 0
    assert np.all(apart[diff > 1e-4])
    assert diff[~apart].max() < 1e-5

    def mse(rgb, keep):
        return float(np.mean((rgb[keep] - gt[keep]) ** 2))

    every = np.ones(o.shape[0], bool)
    assert abs(mse(rgb_j, every) - mse(rgb_t, every)) > 1e-5 * mse(rgb_t, every)
    np.testing.assert_allclose(mse(rgb_j, ~apart), mse(rgb_t, ~apart), rtol=1e-6)
