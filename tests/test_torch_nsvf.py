"""The NSVF (Tanks and Temples) path of the port against the JAX package's,
on the CPU: the loader on tiny scenes written here (both split prefixes,
both intrinsics.txt forms, RGBA and RGB images, bbox.txt), the ``auto``
detection, checkpoints holding an MSI background, ``sparsify_background``,
and the Trainer resumed from a checkpoint with a background, in float64."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.core import topology as JTopo
from alphasurf_tpu.core.grid import create_grid as jax_create_grid
from alphasurf_tpu.utils import io as JIO
from alphasurf_torch.core import topology as TTopo
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.data import NSVFDataset, datasets
from alphasurf_torch.data.nsvf import similarity_from_cameras
from alphasurf_torch.data.synthetic import pose_spherical
from alphasurf_torch.utils import io as TIO
from alphasurf_torch.utils.png import write_png
from test_torch_background import np_background
from test_torch_util import jax_to_np


def write_nsvf_scene(root, side=(12, 16), n=(3, 2, 2), rgba=True, intrinsics="matrix",
                     bbox=False, seed=0):
    """An NSVF-layout scene: rgb/{0,1,2}_XXXX.png (``n`` train, val and test
    images of ``side`` = (H, W), 8-bit RGBA or RGB), pose/*.txt OpenCV c2w
    on a ring at radius 3.5 around an off-centre point (3x4 for the val
    split, 4x4 for the others), intrinsics.txt as a 4x4 matrix or as the
    one line "f cx cy 0.", and optionally bbox.txt."""
    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    (root / "pose").mkdir()
    k = 0
    for split, m in enumerate(n):
        for i in range(m):
            c2w = pose_spherical(360.0 * k / sum(n) + rng.uniform(-5, 5), rng.uniform(-30, 10),
                                 3.5).astype(np.float64)
            c2w[:3, 3] += (0.3, -0.2, 0.5)
            name = f"{split}_{k:04d}"
            np.savetxt(root / "pose" / f"{name}.txt", c2w[:3] if split == 1 else c2w)
            img = rng.integers(0, 256, (*side, 4 if rgba else 3), dtype=np.uint8)
            if rgba:
                img[0, :, 3], img[1, :, 3] = 0, 255
            write_png(root / "rgb" / f"{name}.png", img)
            k += 1
    if intrinsics == "matrix":
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 21.5, 20.5, side[1] / 2 + 0.3, side[0] / 2 - 0.2
        np.savetxt(root / "intrinsics.txt", K)
    else:
        (root / "intrinsics.txt").write_text(f"22.0 {side[1] / 2} {side[0] / 2} 0.\n")
    if bbox:
        np.savetxt(root / "bbox.txt", np.array([[-1.0, -0.8, -1.2, 1.4, 0.9, 1.1, 0.05]]))
    return root


SCENES = {
    "rgba_matrix": dict(),
    "rgb_line": dict(rgba=False, intrinsics="line"),
    "no_test_split": dict(n=(3, 2, 0)),
    "bbox": dict(bbox=True),
}
LOADER_KW = {
    "rgba_matrix": [dict(), dict(white_bkgd=False), dict(scale=0.5)],
    "rgb_line": [dict()],
    "no_test_split": [dict()],
    "bbox": [dict(normalize_by_bbox=True), dict(normalize_by_camera=False, scene_scale=0.7)],
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_nsvf_loader_matches_jax(tmp_path, scene):
    """c2w, gt, intrinsics, the scene scale and the train rays equal JAX's
    NSVFDataset's (the rays to float32 rounding) for every split."""
    imageio = pytest.importorskip("imageio")  # the JAX loader reads the PNGs with it
    del imageio
    from alphasurf_tpu.data.nsvf import NSVFDataset as JNSVF

    root = write_nsvf_scene(tmp_path / "scene", **SCENES[scene])
    for kw in LOADER_KW[scene]:
        for split in ("train", "val", "test", "test_train"):
            got, ref = NSVFDataset(str(root), split, **kw), JNSVF(str(root), split, **kw)
            np.testing.assert_array_equal(got.c2w, ref.c2w)
            np.testing.assert_array_equal(got.gt, ref.gt)
            assert got.gt.dtype == ref.gt.dtype == np.float32
            assert (got.n_images, got.h_full, got.w_full) == (ref.n_images, ref.h_full,
                                                              ref.w_full)
            for k in ("fx", "fy", "cx", "cy"):
                assert getattr(got.intrins_full, k) == getattr(ref.intrins_full, k)
            assert got.scene_scale == ref.scene_scale and got.should_use_background
            assert (got.rays is None) == (split != "train")
        r, j = NSVFDataset(str(root), "train", **kw).rays_init, JNSVF(str(root), "train",
                                                                       **kw).rays_init
        np.testing.assert_array_equal(r.gt, j.gt)
        np.testing.assert_allclose(r.origins, j.origins, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.dirs, j.dirs, rtol=1e-6, atol=1e-6)


def test_similarity_from_cameras_and_auto(tmp_path):
    """The normalisation puts cameras that look at one point at a median
    distance 1 from it, up along -y; ``auto`` falls through to NSVF, and
    CO3D and LLFF still raise, naming their ROADMAP items (§1 items 5 and 4)."""
    from alphasurf_tpu.data.nsvf import similarity_from_cameras as j_sim

    c2w = np.stack([pose_spherical(a, -20.0, 3.0).astype(np.float64) for a in range(0, 360, 45)])
    c2w[:, :3, 3] += (1.0, 2.0, -0.5)
    T, s = similarity_from_cameras(c2w)
    Tj, sj = j_sim(c2w)
    np.testing.assert_array_equal(T, Tj)
    assert s == sj
    t = (T @ c2w)[:, :3, 3] * s
    np.testing.assert_allclose(np.median(np.linalg.norm(t, axis=-1)), 1.0, rtol=1e-12)
    root = write_nsvf_scene(tmp_path / "scene")
    assert isinstance(datasets["auto"](str(root), split="test"), NSVFDataset)
    assert isinstance(datasets["nsvf"](str(root), split="val"), NSVFDataset)
    for name, item, why in (("co3d", 5, "JPEG"), ("llff", 4, "item 4")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP §1 item {item}.*{why}|{why}"):
            datasets[name](str(root), split="train")


def _grid_with_background(reso=8, nlayers=3):
    gj = jax_create_grid(reso, basis_dim=4, init_sigma=0.3, dtype=jnp.float32)
    links, data = np_background(R=8, nlayers=nlayers)
    return gj.replace(background_links=jnp.asarray(links),
                      background_data=jnp.asarray(data, jnp.float32))


def test_checkpoint_round_trip_with_background(tmp_path):
    """JAX save -> port load -> port save -> JAX load: equal arrays, the
    background's links and rows among them; a learned texture basis
    written beside them loads too."""
    gj = _grid_with_background()
    JIO.save_grid(gj, str(tmp_path / "j.npz"), step_id=5)
    g, step = TIO.load_grid(str(tmp_path / "j.npz"), device="cpu")
    assert step == 5 and g.use_background and g.background_nlayers == 3
    assert g.background_reso == 8
    TIO.save_grid(g, str(tmp_path / "t.npz"), step_id=6)
    back, step = JIO.load_grid(str(tmp_path / "t.npz"))
    assert step == 6
    for k in ("links", "density_data", "sh_data", "background_links", "background_data"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), np.asarray(getattr(gj, k)),
                                      err_msg=k)
    z = dict(np.load(tmp_path / "t.npz"))
    z["basis_data"] = np.ones((2, 2, 2, 4), np.float32)
    np.savez(tmp_path / "b.npz", **z)
    gb, _ = TIO.load_grid(str(tmp_path / "b.npz"), device="cpu")
    np.testing.assert_array_equal(gb.basis_data.numpy(), z["basis_data"])
    assert gb.use_background
    a = jax_to_np(gj)
    a["basis_data"] = np.ones((2, 2, 2, 4))
    np.testing.assert_array_equal(SparseGrid.from_numpy(a, device="cpu").basis_data.numpy(),
                                  a["basis_data"])


@pytest.mark.parametrize("thresh,dilate", [(2.4, 1), (1.5, 0), (2.8, 2)])
def test_sparsify_background_matches_jax(thresh, dilate):
    """The kept links and rows equal JAX's host numpy; the foreground is
    carried unchanged."""
    gj = _grid_with_background(nlayers=4)
    g = SparseGrid.from_numpy(jax_to_np(gj) | {
        "background_links": np.asarray(gj.background_links),
        "background_data": np.asarray(gj.background_data)}, device="cpu")
    ref = JTopo.sparsify_background(gj, sigma_thresh=thresh, dilate=dilate)
    got = TTopo.sparsify_background(g, sigma_thresh=thresh, dilate=dilate)
    np.testing.assert_array_equal(got.background_links.numpy(), np.asarray(ref.background_links))
    np.testing.assert_array_equal(got.background_data.detach().numpy(),
                                  np.asarray(ref.background_data))
    assert 0 < got.background_data.shape[0] < gj.background_data.shape[0]
    np.testing.assert_array_equal(got.density_data.detach().numpy(), np.asarray(gj.density_data))


@functools.lru_cache(maxsize=None)
def _datasets():
    from test_torch_trainer import _datasets as trainer_datasets

    return trainer_datasets()


def test_trainer_resumed_with_background_matches_jax(tmp_path, monkeypatch):
    """Both Trainers resume from one checkpoint that holds an MSI
    background (svox2's load_ckpt) and take four warm-start steps, float64
    (JAX's load_grid given dtype float64): each step's mse, the rows, the
    background's rms state (its lr_background is 0, as the JAX Trainer's,
    so its rows stay) and the eval PSNR, rtol 1e-8; the saved checkpoint
    holds the background."""
    from alphasurf_tpu.app import config as JCfg
    from alphasurf_tpu.train import trainer as JT
    from alphasurf_torch.app import config as TCfg
    from alphasurf_torch.train import trainer as TT
    from test_torch_trainer import RUN, _port_copy, _record_mse

    jd, jd_test = _datasets()
    gj = _grid_with_background(16)
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
    assert tt.grid.use_background and "background" in tt.rms
    tt.mse_trace = []
    psnr_t = tt.train()
    assert len(tt.mse_trace) == len(tj.mse_trace) == 4
    np.testing.assert_allclose(tt.mse_trace, tj.mse_trace, rtol=1e-8)
    for f in ("density_data", "sh_data", "background_data"):
        np.testing.assert_allclose(getattr(tt.grid, f).detach().numpy(),
                                   np.asarray(getattr(tj.grid, f)), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_array_equal(tt.grid.background_data.detach().numpy(),
                                  np.asarray(gj.background_data, np.float64))
    rms_bg = tt.rms["background"].numpy()
    assert np.abs(rms_bg).max() > 0
    np.testing.assert_allclose(rms_bg, np.asarray(tj.rms["background"].rms), rtol=1e-8,
                               atol=1e-20)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-8)
    saved, _ = TIO.load_grid(str(tmp_path / "port" / "ckpt.npz"), device="cpu")
    np.testing.assert_array_equal(saved.background_links.numpy(), np.asarray(gj.background_links))
