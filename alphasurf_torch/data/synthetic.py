"""Procedural synthetic dataset (no files needed), the counterpart of the
JAX package's ``data.synthetic``: orbit poses, the known SDF grid and
``SyntheticDataset``, whose ground truth the port's own renderer draws."""
from __future__ import annotations

import numpy as np
import torch

from .. import defs
from ..core.device import resolve_device
from ..core.grid import SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Camera
from .base import DatasetBase, Intrin


def pose_spherical(azimuth_deg: float, elevation_deg: float, radius: float) -> np.ndarray:
    """OpenCV c2w looking at the origin from spherical coordinates."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    eye = radius * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    forward = -eye / np.linalg.norm(eye)  # +z toward origin (OpenCV)
    up = np.array([0.0, 0.0, -1.0])
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def make_gt_grid(reso=32, seed=0, basis_dim=4, dtype=torch.float32, device="cuda") -> SparseGrid:
    """A dense grid holding a positive-inside SDF sphere of radius reso/4,
    raw alpha 3 everywhere and a smooth random SH colour field: the same
    values as the JAX package's ``data.synthetic.make_gt_grid``."""
    reso3 = (reso,) * 3 if isinstance(reso, int) else tuple(reso)
    n3 = int(np.prod(reso3))
    rr = [np.arange(r, dtype=np.float32) for r in reso3]
    X, Y, Z = np.meshgrid(*rr, indexing="ij")
    c = np.asarray(reso3, np.float32) / 2.0
    rs = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
    sdf = (min(reso3) / 4.0 - rs).reshape(-1, 1).astype(np.float32)
    rng = np.random.default_rng(seed)
    coords = np.stack(
        np.meshgrid(*[np.arange(r) for r in reso3], indexing="ij"), axis=-1
    ).reshape(-1, 3) / max(reso3)
    freqs = rng.normal(size=(3, basis_dim * 3)) * 2.0
    phase = rng.uniform(0, 2 * np.pi, basis_dim * 3)
    sh = 0.35 * np.sin(coords @ freqs * 2 * np.pi / 4 + phase)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return SparseGrid.from_numpy(
        {
            "links": np.arange(n3, dtype=np.int32).reshape(reso3),
            "density_data": np.full((n3, 1), 3.0, npdt),
            "sh_data": sh.astype(npdt),
            "surface_data": sdf.astype(npdt),
            "level_set_data": np.zeros(1, npdt),
            "fake_sample_std": None,
            "truncated_vol_render_a": np.asarray(1.0, npdt),
            "radius": np.ones(3, npdt),
            "center": np.zeros(3, npdt),
            "basis_dim": basis_dim,
            "surface_type": defs.SURFACE_TYPE_SDF,
        },
        device=device,
        dtype=dtype,
    )


class SyntheticDataset(DatasetBase):
    """Orbit-camera dataset rendered from ``make_gt_grid`` on ``device``
    (the JAX package's synthetic.py:71-192), the same poses from the same
    seed. As the JAX package does, ``renderer="dense"`` renders the ground
    truth through the dense surface walk (on the card through K11a) on
    host-made rays (``Camera.gen_rays``), and ``"packed"`` through the
    packed renderer on device-made rays. ``dtype`` is the ground-truth
    grid's; the images are stored as float32."""

    def __init__(
        self,
        root: str = "",  # unused; registry compatibility
        split: str = "train",
        n_images: int | None = 20,
        width: int = 64,
        height: int = 64,
        reso: int = 32,
        seed: int = 0,
        epoch_size=None,
        permutation: bool = True,
        renderer: str = "dense",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        super().__init__()
        from ..render.image import render_rays

        if renderer not in ("dense", "packed"):
            raise ValueError(f"renderer must be 'dense' or 'packed', not {renderer!r}")
        dev = resolve_device(device)
        n_images = 20 if n_images is None else n_images
        self.permutation = permutation
        self.epoch_size = epoch_size
        self.split = split
        self.gt_grid = make_gt_grid(reso=reso, seed=seed, dtype=dtype, device=dev)
        opt = RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
        rng = np.random.default_rng(seed + (0 if split == "train" else 1))
        focal = 1.2 * width
        c2ws, imgs = [], []
        for i in range(n_images):
            az = 360.0 * i / n_images + rng.uniform(0, 10)
            el = rng.uniform(-60, 60)
            c2w = pose_spherical(az, el, 2.7)
            cam = Camera.make(c2w, fx=focal, width=width, height=height)
            rays = cam.gen_rays(dev) if renderer == "dense" else cam.gen_rays_device(dev)
            rgb = render_rays(self.gt_grid, rays, opt, renderer=renderer)[0]
            imgs.append(rgb.reshape(height, width, 3).cpu().numpy())
            c2ws.append(c2w)
        self.c2w = np.stack(c2ws)
        self.gt = np.clip(np.stack(imgs), 0.0, 1.0).astype(np.float32)
        self.n_images, self.h_full, self.w_full = n_images, height, width
        self.intrins_full = Intrin(focal, focal, width * 0.5, height * 0.5)
        self.scene_scale = 1.0
        self.should_use_background = False
        if split == "train":
            self.gen_rays()
        else:
            self.h, self.w = height, width
            self.intrins = self.intrins_full
