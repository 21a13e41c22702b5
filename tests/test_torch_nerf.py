"""The NeRF-synthetic (Blender) path of the port against the JAX package's,
on the CPU: the loader on a tiny scene written here (3 train and 2 test
RGBA views at 16x16, by ``utils/png.write_png``), the ``auto`` detection,
render_imgs / eval_imgs / debug_render on one 16^3 checkpoint, the LPIPS
metric with seeded random weights, and the pipeline on such a scene."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from alphasurf_tpu.app import debug_render as j_debug_render
from alphasurf_tpu.app import eval_imgs as j_eval_imgs
from alphasurf_tpu.app import render_imgs as j_render_imgs
from alphasurf_tpu.data.nerf import NeRFDataset as JNeRF
from alphasurf_tpu.render import surface as j_surface
from alphasurf_tpu.utils import lpips as j_lpips
from alphasurf_tpu.utils import metrics as j_metrics
from alphasurf_torch.app import debug_render, eval_imgs, pipeline, render_imgs
from alphasurf_torch.data import NeRFDataset, datasets
from alphasurf_torch.data.synthetic import make_gt_grid, pose_spherical
from alphasurf_torch.utils import lpips, metrics
from alphasurf_torch.utils.io import save_grid
from alphasurf_torch.utils.png import read_png, write_png
from test_lpips import _fake_weights
from test_torch_util import t64  # noqa: F401  (one torch thread, as every port test)

CAMERA_ANGLE_X = 0.6911112  # nerf_synthetic's
GL = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenCV <-> OpenGL camera axes


def write_scene(root, side=16, n_train=3, n_test=2, seed=0):
    """A Blender-layout scene: transforms_{train,test}.json with OpenGL
    poses on the upper hemisphere at radius 2.7 / (2/3), and random 8-bit
    RGBA PNGs (alpha 0 and 255 included)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            c2w = pose_spherical(360.0 * i / n + 17 * (split == "test"), rng.uniform(10, 60),
                                 2.7 * 1.5).astype(np.float64) @ GL
            img = rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
            img[0, :, 3], img[1, :, 3] = 0, 255
            write_png(root / split / f"r_{i}.png", img)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}))
    return root


@pytest.mark.parametrize("kw", [dict(), dict(white_bkgd=False), dict(scale=0.5),
                                dict(n_images=2, scene_scale=0.8)])
def test_nerf_loader_matches_jax(tmp_path, kw):
    """c2w, gt, intrinsics and the train rays equal JAX's NeRFDataset's
    (the rays to float32 rounding); test_train reads the train split."""
    root = write_scene(tmp_path / "scene")
    for split in ("train", "test", "test_train"):
        got, ref = NeRFDataset(str(root), split=split, **kw), JNeRF(str(root), split=split, **kw)
        np.testing.assert_array_equal(got.c2w, ref.c2w)
        np.testing.assert_array_equal(got.gt, ref.gt)
        assert got.gt.dtype == ref.gt.dtype == np.float32
        assert (got.n_images, got.h_full, got.w_full) == (ref.n_images, ref.h_full, ref.w_full)
        for k in ("fx", "fy", "cx", "cy"):
            assert getattr(got.intrins_full, k) == getattr(ref.intrins_full, k)
        assert got.scene_scale == ref.scene_scale and got.split == split
        assert (got.rays is None) == (split != "train")
    r = NeRFDataset(str(root), "train", **kw).rays_init
    j = JNeRF(str(root), "train", **kw).rays_init
    np.testing.assert_array_equal(r.gt, j.gt)
    np.testing.assert_allclose(r.origins, j.origins, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.dirs, j.dirs, rtol=1e-6, atol=1e-6)


def test_auto_tells_scenes_as_jax(tmp_path):
    """transforms_train.json and transforms.json both mean NeRF; LLFF and
    the NSVF fall-through still raise, naming ROADMAP §1."""
    root = write_scene(tmp_path / "scene")
    assert isinstance(datasets["auto"](str(root), split="test"), NeRFDataset)
    only = tmp_path / "only"
    only.mkdir()
    (only / "transforms.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="transforms_test.json"):
        datasets["auto"](str(only), split="test")  # the NeRF loader, as in JAX
    (tmp_path / "llff").mkdir()
    np.save(tmp_path / "llff" / "poses_bounds.npy", np.zeros((2, 17)))
    with pytest.raises(NotImplementedError, match="'llff'.*ROADMAP §1 item 4"):
        datasets["auto"](str(tmp_path / "llff"), split="test")


@pytest.fixture
def scene_ckpt(tmp_path, monkeypatch):
    """The scene, one 16^3 checkpoint (make_gt_grid, step 7) copied into a
    directory per package, and LPIPS weights in $LPIPS_WEIGHTS_DIR."""
    root = write_scene(tmp_path / "scene")
    g = make_gt_grid(16, device="cpu")
    ckpts = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        ckpts[name] = str(tmp_path / name / "ckpt.npz")
        save_grid(g, ckpts[name], step_id=7)
    (tmp_path / "lpips").mkdir()
    _fake_weights(tmp_path / "lpips")
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", str(tmp_path / "lpips"))
    return root, ckpts, tmp_path


def _files(d):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*")
                  if p.is_file() and p.suffix != ".mp4" and p.name != "ckpt.npz")


def _lost_exits(ckpt, dset):
    """Per test view, the rays (H*W,) that lose their exit to the float32
    ray-bounds fault (ROADMAP §3) in either package: float32 bounds with
    no span where float64 ones cross the lattice. The port's eager ops and
    JAX's jitted ones (XLA on the CPU contracts o + t d into fused
    multiply-adds) lose different rays, each of which renders the
    background in one package only."""
    from alphasurf_tpu.core.rays import Camera as JCamera
    from alphasurf_tpu.ops import dda as j_dda
    from alphasurf_tpu.utils.io import load_grid as j_load_grid
    from alphasurf_torch.core.rays import Camera
    from alphasurf_torch.ops import dda
    from alphasurf_torch.utils.io import load_grid

    jg = j_load_grid(ckpt)[0]
    j_bounds = jax.jit(lambda o, d: j_dda.ray_bounds(jg, *j_dda.preprocess_rays(jg, o, d)[:2]))
    grids = [load_grid(ckpt, device="cpu", dtype=dt)[0] for dt in (torch.float32, torch.float64)]
    out = []
    for i in range(dset.n_images):
        H, W = dset.h_full, dset.w_full
        kw = dict(fx=dset.intrins_full.fx, fy=dset.intrins_full.fy, cx=W * 0.5, cy=H * 0.5,
                  width=W, height=H)
        r = Camera.make(dset.c2w[i], **kw).gen_rays_device("cpu")
        spans = []
        for g in grids:
            dt = g.density_data.dtype
            o, d, _, _ = dda.preprocess_rays(g, r.origins.to(dt), r.dirs.to(dt))
            tn, tx = dda.ray_bounds(g, o, d)
            spans.append((tx - tn).numpy())
        jr = JCamera.make(dset.c2w[i], **kw).gen_rays_device()
        tn, tx = j_bounds(jr.origins, jr.dirs)
        spans.append(np.asarray(tx - tn))
        out.append(((spans[0] <= 0) | (spans[2] <= 0)) & (spans[1] > 1e-3))
    return out


def _record(monkeypatch, metrics, lpips_mod):
    """Record the per-view PSNR, SSIM and LPIPS that an app computes
    through ``metrics`` and ``lpips_mod``."""
    rec = {"psnr": [], "ssim": [], "lpips": []}

    def wrap(key, fn):
        def recorded(*a, **k):
            v = fn(*a, **k)
            rec[key].append(float(v))
            return v
        return recorded

    make = lpips_mod.make_lpips
    monkeypatch.setattr(metrics, "psnr", wrap("psnr", metrics.psnr))
    monkeypatch.setattr(metrics, "compute_ssim", wrap("ssim", metrics.compute_ssim))
    monkeypatch.setattr(lpips_mod, "make_lpips", lambda *a, **k: wrap("lpips", make(*a, **k)))
    return rec


def test_image_apps_match_jax(scene_ckpt, monkeypatch, capsys):
    """render_imgs (with depth and LPIPS), eval_imgs (2 views, with depth
    and the truncated render's _truc files, in one call) and debug_render
    (the image, then two pixel probes) on one checkpoint: the same files;
    every pixel within one level but for the rays of the float32
    ray-bounds fault (ROADMAP §3), which render the background in one
    package; each view's PSNR to 1e-6 dB (SSIM and LPIPS to 1e-6) on the
    views that hold none of those rays, of which there is one at least,
    and each app's means those of its views; the probes to 1e-6."""
    root, ck, tmp = scene_ckpt
    d = ["--dataset_type", "nerf"]
    cpu = ["--device", "cpu"]
    lost = _lost_exits(ck["port"], NeRFDataset(str(root), "test"))
    clean = np.nonzero([not m.any() for m in lost])[0]
    assert len(clean) > 0
    rec = {"port": _record(monkeypatch, metrics, lpips),
           "jax": _record(monkeypatch, j_metrics, j_lpips)}
    got = render_imgs.main([ck["port"], str(root), *d, "--render_depth", *cpu])
    ref = j_render_imgs.main([ck["jax"], str(root), *d, "--render_depth"])
    assert np.isfinite(got) and np.isfinite(ref)
    for name in ("port", "jax"):
        stats = json.loads((tmp / name / "test_psnr.txt").read_text())
        assert stats.keys() == {"psnr", "ssim", "lpips", "n"} and stats["n"] == 2
        for k, v in rec[name].items():
            assert len(v) == 2 and stats[k] == np.mean(v), (name, k)
    for k in rec["port"]:
        for i in clean:
            assert abs(rec["port"][k][i] - rec["jax"][k][i]) < 1e-6, (k, i)
    ev = ["-N", "2", "--render_depth", "--truncated_vol_render"]
    pg, ssim_g = eval_imgs.main([ck["port"], str(root), *d, *ev, *cpu])
    pj, ssim_j = j_eval_imgs.main([ck["jax"], str(root), *d, *ev, "--no_vid"])
    assert len(pg) == len(pj) == 2
    for i in clean:
        assert abs(pg[i] - pj[i]) < 1e-6 and abs(ssim_g[i] - ssim_j[i]) < 1e-6, i
    assert (tmp / "port" / "psnr_truc.txt").is_file()
    debug_render.main([ck["port"], str(root), *d, "--img_id", "1", *cpu])
    j_debug_render.main([ck["jax"], str(root), *d, "--img_id", "1"])
    assert _files(tmp / "port") == _files(tmp / "jax")
    for f in _files(tmp / "port"):
        if f.endswith(".png") and "depth" not in f:
            a, b = read_png(tmp / "port" / f).astype(int), read_png(tmp / "jax" / f).astype(int)
            view = 1 if f.startswith("debug") else int(f.split("/")[-1][:4])
            off = np.abs(a - b).reshape(-1, a.shape[-1]).max(-1) > 1
            assert not (off & ~lost[view]).any(), f
    capsys.readouterr()
    probes = debug_render.main([ck["port"], str(root), *d, "--pixel", "8,7", "--pixel", "3,12",
                                *cpu])
    # JAX's probes through its renderer under jit: eager, it compiles each
    # operation of the render, which takes 20 s on the CPU
    monkeypatch.setattr(j_surface, "volume_render_surface_packed", jax.jit(
        j_surface.volume_render_surface_packed, static_argnames=("opt", "entries_per_ray")))
    j_debug_render.main([ck["jax"], str(root), *d, "--pixel", "8,7", "--pixel", "3,12"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("pixel")]
    assert len(lines) == 4 and len(probes) == 2
    num = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"
    for a, b in zip(lines[:2], lines[2:]):
        va, vb = (np.asarray(re.findall(num, ln), float) for ln in (a, b))
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-6)
    assert probes[0]["pixel"] == (8, 7) and probes[0]["n_intersections"] >= 0


def test_lpips_matches_jax(tmp_path, monkeypatch):
    """The port's LPIPS-vgg equals the JAX package's (the same seeded random
    weights, atol 1e-6); make_lpips is None without weight files."""
    vggp, linp = _fake_weights(tmp_path)
    mp, mj = lpips.make_lpips(vggp, linp, device="cpu"), j_lpips.make_lpips(vggp, linp)
    rng = np.random.default_rng(0)
    a = rng.random((48, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (b, a), (a, a)):
        assert abs(mp(x, y) - mj(x, y)) <= 1e-6
    assert mp(a, b) > 0
    monkeypatch.delenv("LPIPS_WEIGHTS_DIR", raising=False)
    assert lpips.make_lpips(device="cpu") is None
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", str(tmp_path))
    assert isinstance(lpips.make_lpips(device="cpu"), lpips.LPIPSVgg)


def test_nerf_pipeline_runs_on_the_cpu(tmp_path):
    """run_pipeline with dataset_type="nerf" at 8^3 on a 16x16 scene: the
    render stage through render_imgs, the Chamfer stage only with GT
    points given, K12d's term on through lambda_surface_eikonal."""
    root = write_scene(tmp_path / "scene", n_train=4)
    gt = tmp_path / "gt.npy"
    np.save(gt, np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32) * 0.3)
    res = pipeline.run_pipeline(
        str(tmp_path / "run"), data_dir=str(root), dataset_type="nerf", reso=8,
        n_iters_plenoxels=10, n_iters_surface=4, batch_size=256, gt_points_path=str(gt),
        overrides_surface={"lambda_surface_eikonal": 1e-3}, device="cpu")
    s = res["summary"]
    assert np.isfinite(s["psnr"]) and np.isfinite(s["chamfer"])
    assert (tmp_path / "run" / "surface" / "test_psnr.txt").is_file()
    assert json.loads((tmp_path / "run" / "surface" / "test_psnr.txt").read_text())["n"] == 2
    assert not (tmp_path / "run" / "gt_pts.npy").exists()
