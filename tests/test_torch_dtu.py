"""The DTU masked-capture path of the port against the JAX package's, on the
CPU: the PNG reader and writer (against imageio), the camera decomposition
(against OpenCV), the area resize (against OpenCV), the DTU loader (against
the JAX DTUDataset on a scene written here), the mask sweep K9f
(``sparse_grid_mask_render``) and the masked ``init_surface_from_density``
(float64), and the DTU-protocol evaluation (``dtu_eval``, ``sample_mesh``,
``app/eval_dtu``; cKDTree against scikit-learn)."""
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from scipy.io import savemat

from alphasurf_tpu.app import eval_dtu as j_eval_dtu
from alphasurf_tpu.core import topology as JT
from alphasurf_tpu.core import weight_render as JW
from alphasurf_tpu.data.base import RayBatch as JRayBatch
from alphasurf_tpu.data.dtu import DTUDataset as JDTU
from alphasurf_tpu.data.dtu import load_K_Rt_from_P as j_load_K_Rt_from_P
from alphasurf_tpu.data.synthetic import pose_spherical
from alphasurf_tpu.geometry import dtu_eval as JE
from alphasurf_torch.app import eval_dtu
from alphasurf_torch.core import topology as T
from alphasurf_torch.core import weight_render as W
from alphasurf_torch.data import DTUDataset, datasets
from alphasurf_torch.data.base import RayBatch, area_resize
from alphasurf_torch.data.dtu import load_K_Rt_from_P, rq_decomp3x3
from alphasurf_torch.geometry import dtu_eval as TE
from alphasurf_torch.utils import png
from test_torch_topology import both, check_both, density_grid


def _images(shape, seed):
    """uint8 noise and a smooth image (the smooth one makes imageio's
    encoder pick the Sub, Up, Average and Paeth filters)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, size=shape).astype(np.uint8)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    smooth = (3 * yy + 5 * xx + (yy * xx) % 7).astype(np.uint8)
    if len(shape) == 3:
        smooth = np.stack([smooth + 40 * c for c in range(shape[2])], -1).astype(np.uint8)
    return noise, smooth


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG of ``img`` whose row y uses filter ``filters[y % len]``."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int64)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        b = x[y - 1] if y else np.zeros(w * ch, np.int64)
        a = np.concatenate([np.zeros(ch, np.int64), x[y, :-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), b[:-ch]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = [np.zeros_like(a), a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][ft]
        rows.append(bytes([ft]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 2), (13, 17, 3), (13, 17, 4)])
def test_png_round_trips_with_imageio(tmp_path, shape):
    """imageio's files read bit-equal to imageio.imread, by the C helper and
    by the plain version; the port's files read bit-equal by imageio; a
    file with every row filter (0-4) reads as imageio reads it."""
    for i, img in enumerate(_images(shape, seed=len(shape))):
        p = tmp_path / f"im{i}.png"
        imageio.imwrite(p, img)
        ref = imageio.imread(p)
        for plain in (False, True):
            got = png.read_png(p, plain=plain)
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        q = tmp_path / f"port{i}.png"
        png.write_png(q, img)
        np.testing.assert_array_equal(imageio.imread(q), img)
        f = tmp_path / f"filters{i}.png"
        f.write_bytes(_filtered_png(img, (0, 1, 2, 3, 4, 4, 3)))
        np.testing.assert_array_equal(png.read_png(f), imageio.imread(f))
        np.testing.assert_array_equal(png.read_png(f, plain=True), img)


def test_load_K_Rt_from_P_matches_cv2():
    """The RQ decomposition equals cv2.decomposeProjectionMatrix's K, R and
    camera centre to 1e-10 on random and DTU-like projections (every sign
    case of the rule); the loader's intrinsics equal the JAX package's to
    1e-10 and its float32 pose to float32 rounding."""
    rng = np.random.default_rng(0)
    for trial in range(300):
        if trial % 2:
            P = rng.normal(size=(3, 4))
        else:
            K = np.array([[2892.3, 0.3, 823.2], [0.0, 2883.2, 619.1], [0.0, 0.0, 1.0]])
            R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            P = (K @ np.concatenate([R, rng.normal(size=(3, 1)) * 300], 1)).astype(np.float32)
        K_ref, R_ref, t_ref = cv2.decomposeProjectionMatrix(P)[:3]
        K_got, R_got = rq_decomp3x3(P[:, :3])
        np.testing.assert_allclose(K_got, K_ref, rtol=1e-10, atol=1e-10 * np.abs(K_ref).max())
        np.testing.assert_allclose(R_got, R_ref, rtol=1e-10, atol=1e-10)
        intr, pose = load_K_Rt_from_P(P)
        intr_j, pose_j = j_load_K_Rt_from_P(P)
        assert intr.dtype == intr_j.dtype and pose.dtype == pose_j.dtype
        np.testing.assert_allclose(intr, intr_j, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(pose[:3, 3], (t_ref[:3] / t_ref[3])[:, 0], rtol=1e-6)
        np.testing.assert_allclose(pose, pose_j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("size", [(37, 29), (40, 36)])
def test_area_resize_matches_cv2(size):
    """Factors 2 and 4 and scales 0.5 and 0.75: float32 within 1e-6, uint8
    within one level of cv2.resize(INTER_AREA)."""
    rng = np.random.default_rng(1)
    h, w = size
    f32 = rng.random((h, w, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    sizes = [(w // 2, h // 2), (w // 4, h // 4), (round(w * 0.5), round(h * 0.5)),
             (round(w * 0.75), round(h * 0.75))]
    for sz in sizes:
        for img, tol in ((f32, 1e-6), (u8, 1)):
            got = area_resize(img, sz)
            ref = cv2.resize(img, sz, interpolation=cv2.INTER_AREA)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert np.abs(got.astype(np.float64) - ref).max() <= tol, sz


def write_scene(root, n=3, side=16, seed=0):
    """A DTU-format scan (IDR layout) of ``n`` side x side views: random
    RGB images and 3-channel masks (a disc, with values around the loader's
    threshold of 50) written by imageio, cameras_sphere.npz with world_mat
    = K [R|t] in millimetres and a scale_mat from the unit sphere."""
    rng = np.random.default_rng(seed)
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    scale = np.eye(4)
    scale[:3, :3] *= 120.0
    scale[:3, 3] = (5.0, -20.0, 600.0)
    mats = {}
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    for i in range(n):
        c2w = pose_spherical(360.0 * i / n + 10.0, 20.0 + 5 * i, 2.7).astype(np.float64)
        c2w[:3, 3] = 120.0 * c2w[:3, 3] + scale[:3, 3]
        K = np.eye(4)
        K[0, 0], K[1, 1] = 1.3 * side + i, 1.3 * side + 0.5 * i
        K[0, 2], K[1, 2] = side / 2 + 0.3 * i, side / 2 - 0.2 * i
        mats[f"world_mat_{i}"] = K @ np.linalg.inv(c2w)
        mats[f"scale_mat_{i}"] = scale
        imageio.imwrite(root / "image" / f"{i:03d}.png",
                        rng.integers(0, 256, (side, side, 3)).astype(np.uint8))
        disc = np.hypot(yy - side / 2, xx - side / 2) < side / 3
        m = np.where(disc, 255, rng.choice([0, 49, 50, 51], size=disc.shape)).astype(np.uint8)
        imageio.imwrite(root / "mask" / f"{i:03d}.png", np.repeat(m[..., None], 3, -1))
    np.savez(root / "cameras_sphere.npz", **mats)
    return root


@pytest.mark.parametrize("kw", [dict(), dict(white_bkgd=False, scene_scale=0.8)])
def test_dtu_loader_matches_jax(tmp_path, kw):
    """c2w, intrinsics, gt, masks and the train rays (with their masks)
    equal the JAX DTUDataset's on a written scene; ``auto`` finds the
    scene. The poses are float32 roundings of float64 decompositions that
    differ from OpenCV's in the last bits, so c2w and the rays are held to
    float32 rounding (rtol 1e-6); gt and masks exactly."""
    root = write_scene(tmp_path / "scan")
    for split in ("train", "test"):
        got = DTUDataset(str(root), split=split, **kw)
        ref = JDTU(str(root), split=split, **kw)
        assert (got.n_images, got.h_full, got.w_full) == (ref.n_images, ref.h_full, ref.w_full)
        np.testing.assert_array_equal(got.gt, ref.gt)
        np.testing.assert_array_equal(got.masks, ref.masks)
        np.testing.assert_allclose(got.c2w, ref.c2w, rtol=1e-6, atol=1e-6)
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(got.intrins_full, k),
                                       getattr(ref.intrins_full, k), rtol=1e-10)
        np.testing.assert_array_equal(got.pt_rescale, ref.pt_rescale)
        assert got.should_use_background is False and got.use_sphere_bound is True
    r = DTUDataset(str(root), "train", **kw).rays_init
    j = JDTU(str(root), "train", **kw).rays_init
    np.testing.assert_array_equal(r.mask, j.mask)
    np.testing.assert_array_equal(r.gt, j.gt)
    np.testing.assert_allclose(r.origins, j.origins, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.dirs, j.dirs, rtol=1e-6, atol=1e-6)
    assert r.mask.any() and not r.mask.all()
    assert isinstance(datasets["auto"](str(root), split="test"), DTUDataset)
    # a directory of no known layout falls through to the NSVF loader, which
    # finds no image directory there, as JAX's does
    from alphasurf_tpu.data import auto_dataset as jax_auto

    for auto in (datasets["auto"], jax_auto):
        with pytest.raises(AssertionError, match="none of \\['images', 'image', 'rgb'\\]"):
            auto(str(tmp_path), split="test")


def test_dtu_loader_scale_matches_jax(tmp_path):
    """scale 0.5 (the area resize of images and masks): intrinsics and
    masks as JAX's, gt within one level of its uint8 (1/255)."""
    root = write_scene(tmp_path / "scan", side=20)
    got, ref = DTUDataset(str(root), "test", scale=0.5), JDTU(str(root), "test", scale=0.5)
    assert got.gt.shape == ref.gt.shape == (3, 10, 10, 3)
    np.testing.assert_allclose(got.gt, ref.gt, atol=1.0 / 255 + 1e-7)
    np.testing.assert_allclose(got.intrins_full.fx, ref.intrins_full.fx, rtol=1e-10)
    assert (got.masks != ref.masks).mean() <= 0.02


def _masked_rays(n=600, seed=5):
    """World rays towards the lattice from two sides, masked where they pass
    within 0.45 of the centre (density_grid's ball has radius 0.5)."""
    rng = np.random.default_rng(seed)
    o = np.where(rng.random((n, 1)) < 0.5, [0.2, -0.1, -2.5], [2.4, 0.3, 0.1])
    d = -o + rng.normal(size=(n, 3)) * 0.35
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    miss = np.linalg.norm(o - np.sum(o * d, -1, keepdims=True) * d, axis=-1)
    return o.astype(np.float32), d.astype(np.float32), miss < 0.45


@pytest.mark.parametrize("near_clip", [0.0, 1.5])
def test_sparse_grid_mask_render_matches_jax(near_clip):
    """K9f's plain version equals the JAX mask sweep exactly, 0/1 per row,
    float64 grids, in chunks of 128 (so the JAX sweep pads its last chunk
    with copies of the last ray, which a 0/1 mask does not see)."""
    gj, gt = both(density_grid())
    o, d, _ = _masked_rays()
    ref = np.asarray(JW.sparse_grid_mask_render(gj, o, d, near_clip=near_clip, chunk=128))
    got = W.sparse_grid_mask_render(gt, torch.as_tensor(o), torch.as_tensor(d),
                                    near_clip=near_clip, chunk=128)
    assert got.dtype == torch.float32 and 0 < float(got.sum()) < gt.capacity
    np.testing.assert_array_equal(got.numpy(), ref)


def test_masked_init_surface_matches_jax(monkeypatch):
    """init_surface_from_density with mask pruning (K9f over the masked
    rays, then the others) against the JAX device path (float64, rtol
    1e-8) and host path (atol 2e-5); the pruning changes the grid."""
    gj, gt = both(density_grid())
    o, d, m = _masked_rays()
    kw = dict(density_lvs=[2.0, 6.0], alpha_rescale=0.005, prune_threshold=1.0, dilate=2)
    port = T.init_surface_from_density(gt, mask_pruning_rays=RayBatch(o, d, o, m), **kw)
    host = JT.init_surface_from_density(gj, mask_pruning_rays=JRayBatch(o, d, o, m), **kw)
    monkeypatch.setattr(JT, "_DEVICE_DISPATCH_SIZE", 1)
    check_both(port, JT.init_surface_from_density(gj, mask_pruning_rays=JRayBatch(o, d, o, m),
                                                  **kw), host)
    unpruned = T.init_surface_from_density(gt, **kw)
    assert port.capacity < unpruned.capacity


def _dtu_dir(tmp_path):
    """tests/test_dtu_eval.py's fixture: an 11^3 ObsMask over BB [0, 100]^3
    observed where x < ~55, the ground plane z > 20, the GT plane z = 30
    over [0, 50]^2 and junk below the plane."""
    d = tmp_path / "MVS Data"
    (d / "ObsMask").mkdir(parents=True)
    (d / "Points" / "stl").mkdir(parents=True)
    ObsMask = np.zeros((11, 11, 11), np.uint8)
    ObsMask[:6] = 1
    savemat(str(d / "ObsMask" / "ObsMask1_10.mat"),
            {"ObsMask": ObsMask, "BB": np.array([[0.0, 0.0, 0.0], [100.0, 100.0, 100.0]]),
             "Res": np.array([[10.0]])})
    savemat(str(d / "ObsMask" / "Plane1.mat"), {"P": np.array([[0.0], [0.0], [1.0], [-20.0]])})
    xs = np.linspace(0, 50, 26)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    gt = np.stack([X.ravel(), Y.ravel(), np.full(X.size, 30.0)], -1)
    junk = gt.copy()
    junk[:, 2] = 10.0
    JE.write_ply_points(str(d / "Points" / "stl" / "stl001_total.ply"),
                        np.concatenate([gt, junk], 0))
    return d


def _prediction(seed=0):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 50, 26)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pred = np.stack([X.ravel(), Y.ravel(), np.full(X.size, 33.0)], -1)
    pred = pred + rng.normal(size=pred.shape) * 0.7
    return np.concatenate([pred, pred + [70.0, 0.0, 0.0], pred + [0.0, 0.0, 500.0],
                           pred[:40] + [0.0, 0.0, 25.0]], 0)


def test_dtu_eval_matches_jax(tmp_path):
    """dtu_eval on the ObsMask fixture (a noisy prediction: culled blocks
    and outliers beyond max_dist) equals the JAX evaluator to 1e-9,
    visualisation colours included."""
    d = str(_dtu_dir(tmp_path))
    pred = _prediction()
    for kw in (dict(), dict(max_dist=2.0, visualize_threshold=1.0)):
        got, ref = TE.dtu_eval(pred, 1, d, **kw), JE.dtu_eval(pred, 1, d, **kw)
        for k in ("mean_d2s", "mean_s2d", "overall"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-9)
        for k, v in ref["vis"].items():
            np.testing.assert_allclose(got["vis"][k], v, rtol=1e-9, atol=1e-12)


def test_sample_mesh_and_radius_ties_match_jax():
    """sample_mesh equals the JAX sampler to 1e-9 on a mesh of triangles of
    many sizes (so of many (n1, n2) grids), in the same order; radius
    downsampling removes points at exactly the radius, as scikit-learn's
    <= does."""
    rng = np.random.default_rng(3)
    verts = rng.random((40, 3)) * 10.0
    tris = rng.integers(0, 40, (60, 3))
    tris[5] = [1, 1, 2]  # degenerate: dropped by both
    for thresh in (0.3, 1.3):
        got, ref = TE.sample_mesh(verts, tris, thresh), JE.sample_mesh(verts, tris, thresh)
        assert got.shape == ref.shape and len(ref) > 50
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    # a lattice of spacing exactly 0.5: every neighbour at the radius ties
    lat = np.stack(np.meshgrid(*[np.arange(6) * 0.5] * 3, indexing="ij"), -1).reshape(-1, 3)
    got, ref = TE.radius_downsample(lat, 0.5), JE.radius_downsample(lat, 0.5)
    np.testing.assert_array_equal(got, ref)
    assert len(got) == len(lat) // 2  # a checkerboard: each kept point removes its 6 ties
    np.testing.assert_array_equal(TE.radius_downsample(lat, 0.5 - 1e-9), lat)


def test_eval_dtu_app_matches_jax(tmp_path):
    """app/eval_dtu on a point file and on an OBJ mesh: the same results to
    1e-9, cf.txt's lines and the vis PLY files, as the JAX CLI's."""
    d = str(_dtu_dir(tmp_path))
    np.save(tmp_path / "pred.npy", _prediction())
    xs = np.linspace(0, 50, 6)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel(), 31.0 + 0.1 * X.ravel()], -1)
    with open(tmp_path / "m.obj", "w") as f:
        for v in V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(5):
            for j in range(5):
                a = i * 6 + j
                f.write(f"f {a + 1} {a + 2} {a + 8}\nf {a + 1} {a + 8} {a + 7}\n")
    for inp in ("pred.npy", "m.obj"):
        args = ["--input_path", str(tmp_path / inp), "--scan", "1", "--dataset_dir", d,
                "--downsample_density", "2.0"]
        got = eval_dtu.main(args + ["--out_dir", str(tmp_path / "t")])
        ref = j_eval_dtu.main(args + ["--out_dir", str(tmp_path / "j")])
        for k in ("mean_d2s", "mean_s2d", "overall"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-9)
        for name in ("vis_001_d2s.ply", "vis_001_s2d.ply"):
            a, b = (JE.load_ply(str(tmp_path / s / name))[0] for s in "tj")
            np.testing.assert_allclose(a, b, rtol=1e-9)
        cf = [[float(ln.split(":")[1]) for ln in (tmp_path / s / "cf.txt").read_text().splitlines()]
              for s in "tj"]
        np.testing.assert_allclose(cf[0], cf[1], rtol=1e-9)
