"""The port's Trainer and its inputs against the JAX package's: schedules,
config parsing, render options, the synthetic dataset, a short cuvol
warm-start run, its checkpoint and the training CLI, on the CPU."""
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.app import config as JCfg
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from alphasurf_tpu.optim import schedules as JS
from alphasurf_tpu.train import trainer as JT
from alphasurf_torch.app import config as TCfg
from alphasurf_torch.data import base as TB
from alphasurf_torch.data.synthetic import SyntheticDataset
from alphasurf_torch.optim import schedules as TS
from alphasurf_torch.train import trainer as TT
from test_torch_util import jax_grid, jax_to_np, t64

# ---------------------------------------------------------------------------
# schedules, render options, config files
# ---------------------------------------------------------------------------

STEPS = [-1, 0, 1, 7, 150, 2999, 15000, 40000, 250000, 400000]


@pytest.mark.parametrize("name,args", [
    ("expon_lr_func", (3e1, 5e-2, 15000, 1e-2, 250000)),
    ("expon_lr_func", (1e-2, 5e-6, 0, 1e-2, 250000, 200)),
    ("expon_lr_func", (0.0, 0.0)),
    ("linear_expon_lr_func", (1.0, 0.05, 3000, 0.1, 50000, 100)),
    ("linear_lr_func", (1e-5, 1e-3, 200, 40000)),
])
def test_schedules_match_jax(name, args):
    fj, ft = getattr(JS, name)(*args), getattr(TS, name)(*args)
    for s in STEPS:
        assert ft(s) == pytest.approx(float(fj(s)), rel=1e-15, abs=0), s


@pytest.mark.parametrize("kind", ["exp", "linear", "linear_expon", "const"])
def test_decay_funcs_match_jax(kind):
    fj = JS.make_decay_func(kind, 1.0, 0.05, 500, 0.1, max_steps=50000, fix_delay_step=10)
    ft = TS.make_decay_func(kind, 1.0, 0.05, 500, 0.1, max_steps=50000, fix_delay_step=10)
    for s in STEPS:
        assert ft(s) == pytest.approx(float(fj(s)), rel=1e-15, abs=0), s


# svox2-style recipe lines (key = value, yaml values, comments, negated and
# unknown flags)
RECIPE = """\
# synthetic recipe
reso = [[128, 128, 128], [256, 256, 256]]
upsamp_every = 38400
n_iters = 102400
lr_sigma = 3e1
lr_sigma_final = 5e-2
lr_sh = 1e-2  # sh learning rate
lambda_tv = 5e-5
lambda_tv_sh = 5e-3
surface_type = sdf
no_surface_init_iters = 12800
surf_init_density_lvs = [0.3, 0.6]
surf_fake_sample = True
truncated_vol_render = true
surf_norm_reg_l1 = True
lambda_normal_loss = 1.0e-5
no_lr_decay = True
no_white_bkgd = False
nokernel = True
some_unknown_flag = 17
dataset_type = synthetic
"""


def test_config_file_parses_to_equal_configs(tmp_path):
    path = tmp_path / "recipe.yaml"
    path.write_text(RECIPE)
    argv = ["data/lego", "-t", str(tmp_path / "ckpt"), "-c", str(path), "--batch_size", "8192",
            "--use_spheric_clip", "--step_size", "0.3"]
    cj, ct = JCfg.load_config(argv), TCfg.load_config(argv)
    assert [f.name for f in dataclasses.fields(ct)] == [f.name for f in dataclasses.fields(cj)]
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.reso == [[128, 128, 128], [256, 256, 256]] and ct.lambda_normal_loss_l1 == 1e-5
    assert ct.lr_decay is False and ct.extra == {"some_unknown_flag": 17}
    # YAML 1.1 reads a float only with a dot: both packages keep "5e-5" as a
    # string (ROADMAP §3)
    assert ct.lambda_tv == "5e-5" and ct.lr_sigma == "3e1" and ct.lr_sigma_final == "5e-2"
    assert TCfg.parse_config_file(str(path)) == JCfg.parse_config_file(str(path))
    assert dataclasses.asdict(TCfg.Config()) == dataclasses.asdict(JCfg.Config())


@pytest.mark.parametrize("no_surface", [False, True])
def test_render_options_from_matches_jax(no_surface):
    cj, ct = JCfg.Config(), TCfg.Config()
    for c in (cj, ct):
        TCfg.apply_dict(c, dict(surf_fake_sample=True, truncated_vol_render=True, near_clip=0.1,
                                surf_alpha_sigmoid_act=True, no_fake_sample_l_dist=True))
    oj = JCfg.render_options_from(cj, no_surface=no_surface)
    ot = TCfg.render_options_from(ct, no_surface=no_surface)
    assert dataclasses.asdict(ot) == {k: v for k, v in dataclasses.asdict(oj).items()
                                      if k in dataclasses.asdict(ot)}


# ---------------------------------------------------------------------------
# the synthetic dataset
# ---------------------------------------------------------------------------

DS = dict(n_images=2, width=16, height=16, reso=16, seed=3)


def test_synthetic_dataset_matches_jax_packed_float32():
    """float32, both on their packed renderers. In float32 both packages'
    ray_bounds may drop a ray's exit (ROADMAP §3); which rays depends on
    rounding, so pixels whose float32 and float64 bounds disagree are left
    out: at most 8 of these 512."""
    from alphasurf_torch.ops import dda

    jd = JaxSynthetic(renderer="packed", **DS)
    td = SyntheticDataset(renderer="packed", device="cpu", **DS)
    np.testing.assert_array_equal(td.c2w, jd.c2w)
    for k in ("origins", "dirs"):
        np.testing.assert_allclose(getattr(td.rays_init, k), getattr(jd.rays_init, k),
                                   rtol=0, atol=1e-6)
    g32 = td.gt_grid
    g64 = pt.SparseGrid.from_numpy(g32.to_numpy(), device="cpu", dtype=torch.float64)
    o, d = torch.as_tensor(td.rays_init.origins), torch.as_tensor(td.rays_init.dirs)
    b32 = dda.ray_bounds(g32, *dda.preprocess_rays(g32, o, d)[:2])
    b64 = dda.ray_bounds(g64, *dda.preprocess_rays(g64, o.double(), d.double())[:2])
    hit32 = (b32[1] > b32[0]).numpy()
    hit64 = (b64[1] > b64[0]).numpy()
    fragile = hit32 != hit64
    assert fragile.sum() <= 8
    got, ref = td.rays_init.gt[~fragile], jd.rays_init.gt[~fragile]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    assert got.std() > 0.05


def test_synthetic_dataset_float64_matches_jax_dense_walk():
    """The port renders the GT of ``renderer="dense"`` through its dense
    walk, as the JAX package does (its default); float64."""
    from alphasurf_tpu.data.synthetic import make_gt_grid, pose_spherical
    from alphasurf_tpu.render.surface import volume_render_surface

    td = SyntheticDataset(renderer="dense", device="cpu", dtype=torch.float64, **DS)
    gj = jax_grid(jax_to_np(make_gt_grid(DS["reso"], seed=DS["seed"])), jnp.float64)
    opt = at.RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    rng = np.random.default_rng(DS["seed"])
    for i in range(DS["n_images"]):
        az = 360.0 * i / DS["n_images"] + rng.uniform(0, 10)
        c2w = pose_spherical(az, rng.uniform(-60, 60), 2.7)
        np.testing.assert_array_equal(td.c2w[i], c2w)
        cam = at.Camera.make(jnp.asarray(c2w), fx=1.2 * DS["width"], width=DS["width"],
                             height=DS["height"])
        ref = np.clip(np.asarray(volume_render_surface(gj, cam.gen_rays(), opt)["rgb"]), 0, 1)
        np.testing.assert_allclose(td.gt[i].reshape(-1, 3), ref, rtol=0, atol=1e-6)
        assert ref.std() > 0.05


def test_synthetic_dataset_dense_matches_jax_float32():
    """float32, both through their dense walks on host-made rays (the
    float32 walks visit the same voxels, tests/test_torch_dense.py). Pixels
    whose float32 and float64 ray bounds disagree (ROADMAP §3) are left
    out, as in the packed test: at most 8 of these 512."""
    from alphasurf_torch.ops import dda

    jd = JaxSynthetic(renderer="dense", **DS)
    td = SyntheticDataset(renderer="dense", device="cpu", **DS)
    np.testing.assert_array_equal(td.c2w, jd.c2w)
    g32 = td.gt_grid
    g64 = pt.SparseGrid.from_numpy(g32.to_numpy(), device="cpu", dtype=torch.float64)
    o, d = torch.as_tensor(td.rays_init.origins), torch.as_tensor(td.rays_init.dirs)
    b32 = dda.ray_bounds(g32, *dda.preprocess_rays(g32, o, d)[:2])
    b64 = dda.ray_bounds(g64, *dda.preprocess_rays(g64, o.double(), d.double())[:2])
    fragile = (b32[1] > b32[0]).numpy() != (b64[1] > b64[0]).numpy()
    assert fragile.sum() <= 8
    got, ref = td.rays_init.gt[~fragile], jd.rays_init.gt[~fragile]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    assert got.std() > 0.05


def _port_copy(jd):
    """A port dataset holding the JAX dataset's very poses and images."""
    d = TB.DatasetBase()
    d.split, d.n_images, d.h_full, d.w_full = jd.split, jd.n_images, jd.h_full, jd.w_full
    d.intrins_full = TB.Intrin(**dataclasses.asdict(jd.intrins_full))
    d.c2w, d.gt = jd.c2w, jd.gt
    d.should_use_background = jd.should_use_background
    if d.split == "train":
        d.gen_rays()
    else:
        d.h, d.w, d.intrins = d.h_full, d.w_full, d.intrins_full
    return d


def test_dataset_registry_rays_and_shuffle():
    from alphasurf_torch.data import datasets

    assert datasets["synthetic"] is SyntheticDataset
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
        datasets["llff"]("data/fern")
    jd = JaxSynthetic(renderer="packed", **DS)
    td = _port_copy(jd)
    for k in ("origins", "dirs", "gt"):
        np.testing.assert_array_equal(getattr(td.rays_init, k), getattr(jd.rays_init, k))
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        jd.shuffle_rays(rj)
        perm = td.shuffle_perm(rt)
        td.to_device("cpu")
        for k in ("origins", "dirs", "gt"):
            np.testing.assert_array_equal(td.rays_dev[k][torch.as_tensor(perm)].numpy(),
                                          getattr(jd.rays, k))


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

RUN = dict(reso=[[16, 16, 16]], surface_type="none", batch_size=256, n_iters=10,
           lambda_tv=0.0, lambda_tv_sh=0.0, print_every=5, save_every=0, eval_every_iter=5,
           n_eval_test=1, tune_mode=True, seed=11, entries_per_ray=64.0, sh_dim=4,
           )


def _record_mse(monkeypatch, cls):
    """Record each step's mse, reading it as the step returns."""
    orig = cls._get_step

    def get_step(self, kind, no_surface):
        fn = orig(self, kind, no_surface)

        def step(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.mse_trace.append(float(out[2]["mse"]))
            assert int(out[2]["pool_overflow"]) == 0
            return out

        return step

    monkeypatch.setattr(cls, "_get_step", get_step)


@functools.lru_cache(maxsize=None)
def _datasets():
    return (JaxSynthetic(renderer="packed", n_images=4, width=16, height=16, reso=16, seed=0),
            JaxSynthetic(split="test", renderer="packed", n_images=2, width=16, height=16,
                         reso=16, seed=0))


def test_cuvol_trainer_run_matches_jax(tmp_path, monkeypatch):
    """Ten warm-start steps of both Trainers, float64 grids, the same GT
    arrays, the JAX Trainer in host mode (the batch stream of both is
    np.random.default_rng(seed)'s permutations). The TV weights are 0, so
    the two packages' different window draws do not enter. The JAX Trainer
    builds its grid through ``create_grid``, here given dtype float64.
    Tolerance: rtol 1e-8 on each step's mse, the final rows and the eval
    PSNR."""
    jd, jd_test = _datasets()
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)

    cj = JCfg.apply_dict(JCfg.Config(), dict(RUN, train_dir=str(tmp_path / "jax")))
    tj = JT.Trainer(cj, jd, jd_test)
    tj.mse_trace = []
    psnr_j = tj.train()

    ct = TCfg.apply_dict(TCfg.Config(), dict(RUN, train_dir=str(tmp_path / "port")))
    tt = TT.Trainer(ct, _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    psnr_t = tt.train()

    assert len(tt.mse_trace) == len(tj.mse_trace) == 10
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    assert tt.mse_trace[-1] < 0.8 * tt.mse_trace[0]
    for f in ("density_data", "sh_data"):
        got = getattr(tt.grid, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-8)
    for name in ("test_psnr.txt", "eval_views.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert sum("eval stats" in ln for ln in tt.log_lines) == 3  # steps 5 and 10, final


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A short port run saves a checkpoint that the JAX package loads."""
    from alphasurf_tpu.utils.io import load_grid as jax_load_grid

    jd, jd_test = _datasets()
    cfg = TCfg.apply_dict(TCfg.Config(), dict(RUN, n_iters=2, eval_every_iter=0,
                                              train_dir=str(tmp_path)))
    tr = TT.Trainer(cfg, _port_copy(jd), _port_copy(jd_test), device="cpu")
    tr.train()
    gj, step_id = jax_load_grid(str(tmp_path / "ckpt.npz"))
    assert step_id == 2 and gj.surface_data is None
    np.testing.assert_array_equal(np.asarray(gj.links), tr.grid.links.numpy())
    np.testing.assert_array_equal(np.asarray(gj.density_data),
                                  tr.grid.density_data.detach().numpy())
    np.testing.assert_allclose(np.asarray(gj.sh_data), tr.grid.sh_data.detach().numpy(),
                               rtol=1e-3, atol=1e-4)  # stored as float16, as JAX stores it
    # and the port resumes it
    cfg.load_ckpt, cfg.n_iters = True, 3
    tr2 = TT.Trainer(cfg, _port_copy(jd), _port_copy(jd_test), device="cpu")
    assert tr2.gstep == 2 and tr2.grid.capacity == tr.grid.capacity
    tr2.train()
    assert tr2.gstep == 3


# the three stages at a tiny size: warm start at 8^3, density resample
# 8^3 -> 8^3 and init_surface_from_density at step 4, surface stage, upsample
# to 12^3 at step 8, surface stage; the Config's weight threshold and
# visibility pruning; the TV weights 0 (the packages draw their windows
# differently)
STAGES = dict(RUN, reso=[[8, 8, 8], [8, 8, 8], [12, 12, 12]], surface_type="sdf", n_iters=12,
              no_surface_init_iters=4, upsamp_every=4, lambda_tv_alpha=0.0, print_every=4,
              eval_every_iter=0, thresh_type="weight", visibility_pruning_scale=0.01)


def test_three_stage_trainer_run_matches_jax(tmp_path, monkeypatch):
    """Both Trainers through every transition, float64 grids, the JAX
    Trainer in host mode. The JAX package runs its transitions on the host
    below 128^3 and on the device above; the port has the device path's
    semantics, so the JAX Trainer takes its device path here too (dispatch
    size 1; tests/test_torch_topology.py holds the port against both).
    The JAX sweeps pad each camera's 256 rays with copies of its last ray,
    which misses the grid for these four cameras, so they add nothing.
    Tolerance rtol 1e-8 on every step's mse and the final rows; the
    capacity after each transition is equal. Both packages render the eval
    images in float32 and take their mse in float32, so a last-bit
    difference in any pixel moves the eval PSNR by up to ~1e-7 of itself:
    rtol 1e-6 there."""
    from alphasurf_tpu.core import topology as JTopo

    jd, jd_test = _datasets()
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    monkeypatch.setattr(JTopo, "_DEVICE_DISPATCH_SIZE", 1)
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)

    cj = JCfg.apply_dict(JCfg.Config(), dict(STAGES, train_dir=str(tmp_path / "jax")))
    tj = JT.Trainer(cj, jd, jd_test)
    tj.mse_trace = []
    psnr_j = tj.train()

    ct = TCfg.apply_dict(TCfg.Config(), dict(STAGES, train_dir=str(tmp_path / "port")))
    tt = TT.Trainer(ct, _port_copy(jd), _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    psnr_t = tt.train()

    assert len(tt.mse_trace) == len(tj.mse_trace) == 12
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    caps_j = [int(ln.split()[-1]) for ln in tj.log_lines if ln.startswith("[stage] new capacity")]
    assert [r["kind"] for r in tt.transitions] == ["upsample", "init_surface_from_density",
                                                   "upsample"]
    assert [r["capacity"] for r in tt.transitions if r["kind"] == "upsample"] == caps_j
    assert tt.transitions[1]["capacity"] < tt.transitions[0]["capacity"]  # pruned
    assert json.loads((tmp_path / "port" / "transitions.json").read_text()) == tt.transitions
    up = tt.transitions[2]
    assert up["seconds"] > 0 and up["occupied_after"] >= up["occupied_before"] > 0
    assert tt.grid.reso == (12, 12, 12) and tt.grid.capacity == tj.grid.capacity
    np.testing.assert_array_equal(tt.grid.links.numpy(), np.asarray(tj.grid.links))
    for f in ("density_data", "sh_data", "surface_data"):
        got = getattr(tt.grid, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_array_equal(tt.grid.level_set_data.numpy(), np.asarray(tj.grid.level_set_data))
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-6)
    # the first upsample turned TV off (tv_early_only)
    assert ct.lambda_tv == ct.lambda_tv_sh == ct.lambda_tv_alpha == 0.0


def test_unported_stages_raise(tmp_path, monkeypatch):
    """What the port's Trainer does not carry yet raises: multi-device runs.
    The surf_init_type="weight" transition (K9e) with mask pruning (K9f,
    the dataset's rays masked where their pixel is not the white
    background, as DTU's foreground masks are), ported, runs as the JAX
    Trainer's: float64 grids, host mode, the JAX transitions on their
    device path, through the first two stages of
    test_three_stage_trainer_run_matches_jax with the weight init (4 warm
    start and 4 surface steps: the weight init and the mask sweep are
    this test's point, and the 12^3 upsample after them is the three-stage
    test's), rtol 1e-8. The JAX Trainer's transmittance march is the port's here: the
    two marches' float32 maxima differ in the last bit
    (test_torch_weight_render holds them against each other), and where
    the surface, density x weight minus the zero level, cancels, one bit
    of a weight moves it by its own size."""
    from alphasurf_tpu.core import topology as JTopo
    from alphasurf_tpu.core import weight_render as JW
    from alphasurf_torch.core import weight_render as W

    def port_sweep(grid, cams):
        g = pt.SparseGrid.from_numpy(jax_to_np(grid), device="cpu")
        tc = [pt.Camera.make(np.asarray(c.c2w), fx=float(c.fx), fy=float(c.fy), cx=float(c.cx),
                             cy=float(c.cy), width=c.width, height=c.height) for c in cams]
        return jnp.asarray(W.sparse_grid_weight_render(g, tc).numpy())

    jd, jd_test = _datasets()
    for kw, item in ((dict(n_devices=2), "item 3"), (dict(mesh_model=2), "item 3")):
        cfg = TCfg.apply_dict(TCfg.Config(), dict(RUN, train_dir=str(tmp_path), **kw))
        with pytest.raises(NotImplementedError, match=item):
            TT.Trainer(cfg, _port_copy(jd), device="cpu")
    mask = jd.rays_init.gt.min(-1) < 0.99
    assert 0 < mask.sum() < mask.size
    # the datasets are shared (lru_cache) by every Trainer test of this
    # worker process: the masks are set for this test only
    for rays in (jd.rays_init, jd.rays):
        monkeypatch.setattr(rays, "mask", mask, raising=False)
    tdset = _port_copy(jd)
    tdset.rays_init.mask = tdset.rays.mask = mask
    swept = []
    mask_render = W.sparse_grid_mask_render
    monkeypatch.setattr(W, "sparse_grid_mask_render",
                        lambda g, o, d, **kw: swept.append(len(o)) or mask_render(g, o, d, **kw))
    weight = dict(STAGES, reso=[[8, 8, 8], [8, 8, 8]], n_iters=8, surf_init_type="weight")
    monkeypatch.setattr(JT, "create_grid", functools.partial(jax_create_grid, dtype=jnp.float64))
    monkeypatch.setattr(JTopo, "_DEVICE_DISPATCH_SIZE", 1)
    monkeypatch.setattr(JW, "sparse_grid_weight_render", port_sweep)
    for cls in (JT.Trainer, TT.Trainer):
        _record_mse(monkeypatch, cls)
        monkeypatch.setattr(cls, "mse_trace", None, raising=False)
    tj = JT.Trainer(JCfg.apply_dict(JCfg.Config(), dict(weight, train_dir=str(tmp_path / "j"))),
                    jd, jd_test)
    tj.mse_trace = []
    psnr_j = tj.train()
    tt = TT.Trainer(TCfg.apply_dict(TCfg.Config(), dict(weight, train_dir=str(tmp_path / "t"))),
                    tdset, _port_copy(jd_test), device="cpu", dtype=torch.float64)
    tt.mse_trace = []
    psnr_t = tt.train()
    assert [r["kind"] for r in tt.transitions] == ["upsample", "init_surface_from_density"]
    assert swept == [int(mask.sum()), int((~mask).sum())]  # the masked rays, then the rest
    assert tt.grid.capacity == tj.grid.capacity and tt.grid.surface_data is not None
    assert len(tt.mse_trace) == len(tj.mse_trace) == 8
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    np.testing.assert_allclose(tt.grid.surface_data.detach().numpy(),
                               np.asarray(tj.grid.surface_data), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-6)


def test_train_cli_runs_on_the_cpu(tmp_path):
    from alphasurf_torch.app import train

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("dataset_type = synthetic\nreso = [[16, 16, 16]]\nsh_dim = 4\n"
                   "dataset_width = 16\ndataset_height = 16\ndataset_reso = 16\n"
                   "dataset_renderer = packed\ndataset_test_images = 1\n")
    psnr = train.main(["", "-t", str(tmp_path / "ckpt"), "-c", str(cfg), "--n_iters", "3",
                       "--batch_size", "128", "--n_train_images", "2", "--print_every", "1",
                       "--device", "cpu"])
    assert np.isfinite(psnr)
    assert (tmp_path / "ckpt" / "ckpt.npz").exists()
    assert float((tmp_path / "ckpt" / "test_psnr.txt").read_text()) == pytest.approx(psnr)


def test_recipe_run_runs_on_the_cpu(tmp_path):
    """app/recipe_run (tools/recipe_run.py's three stages) at a tiny size:
    the stages run, and the result line carries the final eval's PSNR and
    SSIM and the wall time."""
    from alphasurf_torch.app import recipe_run

    out = recipe_run.main([str(tmp_path), "--width", "16", "--n_images", "2", "--gt_reso", "16",
                           "--reso", "8", "8", "8", "--steps", "2", "2", "2", "--batch", "128",
                           "--seed", "1", "--device", "cpu"])
    assert np.isfinite(out["psnr"]) and 0 < out["ssim"] <= 1 and out["wall_s"] > 0
    assert out["stages"] == [2, 2, 2] and out["reso"] == [8, 8, 8] and out["seed"] == 1
    assert json.loads((tmp_path / "result.json").read_text()) == out
    assert (tmp_path / "ckpt" / "ckpt.npz").exists()
