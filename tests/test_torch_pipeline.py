"""The port's evaluation inside and after training against the JAX
package's, on the CPU: the Trainer's in-training extraction and Chamfer
(``_eval_points``, the port of tests/test_eval_points.py) and a micro run of
the five-stage pipeline (``app/pipeline.run_pipeline``), whose extract and
Chamfer stages are held against the JAX apps run on the port's surface
checkpoint."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.app import config as JCfg
from alphasurf_tpu.app import eval_cf as j_eval_cf
from alphasurf_tpu.app import extract_points as j_extract_points
from alphasurf_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from alphasurf_tpu.data.synthetic import make_gt_grid as jax_make_gt_grid
from alphasurf_tpu.train import trainer as JT
from alphasurf_torch.app import config as TCfg
from alphasurf_torch.app import pipeline
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.train import trainer as TT
from test_torch_trainer import _port_copy
from test_torch_util import jax_grid, jax_to_np


@pytest.mark.parametrize("eval_cf,level_sets", [(True, [0.0]), (True, [0.0, 1.0]),
                                                (False, [0.0, 1.0])])
def test_eval_points_matches_jax(tmp_path, eval_cf, level_sets):
    """make_gt_grid(16) in float64 in both Trainers (their points are then
    equal bit for bit, tests/test_torch_extract.py), one level set or two;
    the GT the analytic sphere in the extractor's frame (radius 0.5 / (2/3)
    world units). The same cf_* tail to rtol 1e-6 and the same files."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.save(data_dir / "shape.npy", (d * 0.5 / (2.0 / 3.0)).astype(np.float32))
    jd = JaxSynthetic(renderer="packed", n_images=2, width=16, height=16, reso=16, seed=0)
    a = jax_to_np(jax_make_gt_grid(16))
    a["level_set_data"] = np.asarray(level_sets)
    kw = dict(reso=[[16, 16, 16]], surface_type="none", log_pts=True, eval_cf=eval_cf,
              surf_eval_n_sample=3, surf_eval_intersect_th=0.1, data_dir=str(data_dir),
              tune_mode=True, sh_dim=4)
    tails = {}
    for name, mod, make in (("jax", JCfg, lambda c: JT.Trainer(c, jd)),
                            ("port", TCfg, lambda c: TT.Trainer(c, _port_copy(jd), device="cpu",
                                                                dtype=torch.float64))):
        tr = make(mod.apply_dict(mod.Config(), dict(kw, train_dir=str(tmp_path / name))))
        tr.grid = (jax_grid(a, jnp.float64) if name == "jax"
                   else SparseGrid.from_numpy(a, device="cpu", dtype=torch.float64))
        tails[name] = tr._eval_points()
    out = {n: tmp_path / n / "coarse_pts_eval" / "0" for n in ("jax", "port")}
    names = sorted(p.name for p in out["jax"].iterdir())
    assert names == sorted(p.name for p in out["port"].iterdir())
    assert names == (["cf.txt", "vis_d2s.ply"] if eval_cf else ["pts.ply"])
    ply = names[-1]
    assert (out["port"] / ply).read_text() == (out["jax"] / ply).read_text()
    assert len((out["port"] / ply).read_text().splitlines()) > 1000
    if not eval_cf:
        assert tails == {"jax": "", "port": ""}
        return
    vals = {n: [float(x.split("=")[1]) for x in t.split()] for n, t in tails.items()}
    assert [x.split("=")[0] for x in tails["port"].split()] == ["cf_d2s", "cf_s2d", "cf_mean"]
    np.testing.assert_allclose(vals["port"], vals["jax"], rtol=1e-6)
    cf = {n: [float(ln.split(":")[1]) for ln in (out[n] / "cf.txt").read_text().splitlines()]
          for n in out}
    np.testing.assert_allclose(cf["port"], cf["jax"], rtol=1e-6)
    assert cf["port"][2] < 0.1  # sub-voxel: a voxel is (2/16)/(2/3) world units


def test_eval_stats_line_carries_the_chamfer(tmp_path):
    """eval_step appends the cf_* tail to its ``eval stats:`` line."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.save(data_dir / "shape.npy", pipeline.synthetic_gt_points(16, n=2000) / (2.0 / 3.0))
    jd = JaxSynthetic(renderer="packed", n_images=2, width=16, height=16, reso=16, seed=0)
    cfg = TCfg.apply_dict(TCfg.Config(), dict(
        reso=[[16, 16, 16]], surface_type="none", log_pts=True, eval_cf=True, n_eval_test=1,
        data_dir=str(data_dir), train_dir=str(tmp_path / "t"), tune_mode=True, sh_dim=4))
    tr = TT.Trainer(cfg, _port_copy(jd), _port_copy(jd), device="cpu")
    tr.grid = SparseGrid.from_numpy(jax_to_np(jax_make_gt_grid(16)), device="cpu")
    tr.eval_step()
    line = [ln for ln in tr.log_lines if ln.startswith("eval stats:")][-1]
    assert " cf_d2s=" in line and float(line.split("cf_mean=")[1]) < 0.1


def test_pipeline_runs_end_to_end_on_the_cpu(tmp_path):
    """A micro run (10^3, four 16x16 views, the weight init of the surface
    stage): every stage runs and writes its artifacts; the extract and
    Chamfer stages equal the JAX apps run on the port's surface checkpoint
    (float32 grids: points to atol 1e-6)."""
    res = pipeline.run_pipeline(
        str(tmp_path), reso=10, n_train_images=4, image_size=16, n_iters_plenoxels=40,
        n_iters_surface=10, batch_size=256, n_eval_images=2,
        overrides_surface={"surf_init_type": "weight"}, device="cpu")
    s = res["summary"]
    assert np.isfinite(s["psnr"]) and res["stages"]["extract"]["n_points"] > 100
    for f in ("pipeline_results.json", "surface/ckpt.npz", "plenoxels/ckpt.npz", "pts.npy",
              "gt_pts.npy", "surface/transitions.json"):
        assert (tmp_path / f).is_file(), f
    assert json.loads((tmp_path / "pipeline_results.json").read_text())["summary"] == s
    ref = j_extract_points.main([str(tmp_path / "surface" / "ckpt.npz"), "--intersect_th", "0.1",
                                 "--n_sample", "5", "--out", str(tmp_path / "j_pts.npy")])
    got = np.load(tmp_path / "pts.npy")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    cf = j_eval_cf.main([str(tmp_path / "j_pts.npy"), str(tmp_path / "gt_pts.npy")])
    np.testing.assert_allclose(s["chamfer"], cf["overall"], rtol=1e-6)
    np.testing.assert_allclose(res["stages"]["chamfer"]["d2s"], cf["d2s"], rtol=1e-6)
    # a loader that is not ported raises before any stage runs
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
        pipeline.run_pipeline(str(tmp_path / "llff"), dataset_type="llff", device="cpu")


def test_lr_probe_records_each_surface_step(tmp_path):
    """app/lr_probe at 8^3 (four 16x16 views): a record per surface step
    for each init and rate. Both rates start from the same init and the
    same first batch, and RMSprop's first update is lr g / (sqrt(1 - beta)
    |g| + eps), so the first step moves the same rows 1000x further at 1e-2
    than at 1e-5."""
    from alphasurf_torch.app import lr_probe

    rows = lr_probe.main(["--out_dir", str(tmp_path), "--resos", "8", "--n_train_images", "4",
                          "--image_size", "16", "--n_iters_plenoxels", "20",
                          "--n_iters_surface", "3", "--batch_size", "256", "--device", "cpu"])
    assert [(r["init"], r["lr"]) for r in rows] == [("weight", 1e-2), ("weight", 1e-5),
                                                    ("density", 1e-2), ("density", 1e-5)]
    for fast, slow in (rows[:2], rows[2:]):
        assert fast["steps"] == slow["steps"] == 3 and fast["voxel"] == pytest.approx(2 / 8)
        assert all(np.isfinite(r[k]) for r in (fast, slow)
                   for k in ("psnr_init", "psnr_final", "psnr_plenoxels"))
        assert fast["psnr_init"] == slow["psnr_init"]
        f, s = fast["first_step"], slow["first_step"]
        assert f["rows"] == s["rows"] > 0
        np.testing.assert_allclose(f["mean"], 1000 * s["mean"], rtol=1e-3)
        np.testing.assert_allclose(f["max"], 1000 * s["max"], rtol=1e-3)
        assert s["over_voxel"] == 0.0


@pytest.mark.slow
def test_surface_stage_on_its_init_matches_jax_in_sign(tmp_path, monkeypatch):
    """Both packages' run_pipeline at tests/test_pipeline.py's micro
    configuration (24^3, 16 views at 40x40, 300 + 100 steps of 1600 rays,
    lr_surface 1e-2, lambda_tv 1e-5), the JAX ground truth rendered by its
    packed renderer as the port's is. Four numbers each: the Plenoxels
    PSNR, the PSNR of the surface init (the surface Trainer's eval right
    after init_surface_from_density), the final PSNR and the Chamfer. The
    surface stage's PSNR change on its init has the same sign in both."""
    import functools

    from alphasurf_tpu import data as jdata

    monkeypatch.setitem(jdata.datasets, "synthetic",
                        functools.partial(JaxSynthetic, renderer="packed"))
    init_psnr = {}

    def recording(name, base):
        class Recording(base):
            def train(self, n_iters=None):
                if self.pretrained_density and not self.surface_initialized:
                    self.maybe_init_surface()
                    init_psnr[name] = self.eval_step(final=True)
                return super().train(n_iters)

        return Recording

    monkeypatch.setattr(JT, "Trainer", recording("jax", JT.Trainer))
    monkeypatch.setattr(TT, "Trainer", recording("port", TT.Trainer))
    from alphasurf_tpu.app import pipeline as jpipeline

    kw = dict(reso=24, n_train_images=16, image_size=40, n_iters_plenoxels=300,
              n_iters_surface=100, batch_size=1600, overrides_plenoxels={"lambda_tv": 1e-5})
    res = {"jax": jpipeline.run_pipeline(str(tmp_path / "jax"), **kw),
           "port": pipeline.run_pipeline(str(tmp_path / "port"), device="cpu", **kw)}
    nums = {n: {"plenoxels": r["stages"]["plenoxels"]["psnr"], "init": init_psnr[n],
                "final": r["summary"]["psnr"], "chamfer": r["summary"]["chamfer"]}
            for n, r in res.items()}
    print("four numbers:", json.dumps(nums))
    for n in nums.values():
        assert all(np.isfinite(v) for v in n.values()), nums
    gain = {n: v["final"] - v["init"] for n, v in nums.items()}
    assert np.sign(gain["port"]) == np.sign(gain["jax"]), nums
