"""Dataset base: images and poses -> shuffled ray batches, a copy of the JAX
package's ``data.base`` (svox2's opt/util/dataset_base.py:27-78 and its
``Rays``/``Intrin`` helpers) in numpy.

``to_device`` keeps the whole train ray table on an explicit torch device
(svox2 keeps its shuffled ray table on the GPU too); the Trainer then
gathers each batch there by index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass
class Intrin:
    fx: float
    fy: float
    cx: float
    cy: float

    def scale(self, s: float) -> "Intrin":
        return Intrin(self.fx * s, self.fy * s, self.cx * s, self.cy * s)


@dataclasses.dataclass
class RayBatch:
    origins: np.ndarray  # (N, 3)
    dirs: np.ndarray  # (N, 3)
    gt: np.ndarray  # (N, 3)
    mask: Optional[np.ndarray] = None  # (N,) for masked datasets (DTU)

    def __len__(self):
        return self.origins.shape[0]

    def __getitem__(self, key):
        return RayBatch(
            self.origins[key], self.dirs[key], self.gt[key],
            None if self.mask is None else self.mask[key],
        )


class DatasetBase:
    split: str
    n_images: int
    h_full: int
    w_full: int
    intrins_full: Intrin
    c2w: np.ndarray  # (n, 4, 4) OpenCV
    gt: np.ndarray  # (n, h, w, 3)

    def __init__(self):
        self.ndc_coeffs = (-1.0, -1.0)
        self.use_sphere_bound = True
        self.should_use_background = True
        self.scene_center = [0.0, 0.0, 0.0]
        self.scene_radius = [1.0, 1.0, 1.0]
        self.permutation = True
        self.epoch_size: Optional[int] = None
        self.rays: Optional[RayBatch] = None
        self.rays_dev: Optional[dict] = None
        self.masks: Optional[np.ndarray] = None  # (n, h, w) optional

    def gen_rays(self, factor: int = 1):
        """All-pixel rays for the train split (dataset_base.py:36-71)."""
        self.factor = factor
        self.h = self.h_full // factor
        self.w = self.w_full // factor
        true_factor = self.h_full / self.h
        self.intrins = self.intrins_full.scale(1.0 / true_factor)
        yy, xx = np.meshgrid(
            np.arange(self.h, dtype=np.float32) + 0.5,
            np.arange(self.w, dtype=np.float32) + 0.5,
            indexing="ij",
        )
        # intrinsics may be scalars or per-image arrays (DTU)
        fx = np.atleast_1d(np.asarray(self.intrins.fx, np.float32))[:, None, None]
        fy = np.atleast_1d(np.asarray(self.intrins.fy, np.float32))[:, None, None]
        cx = np.atleast_1d(np.asarray(self.intrins.cx, np.float32))[:, None, None]
        cy = np.atleast_1d(np.asarray(self.intrins.cy, np.float32))[:, None, None]
        xx = (xx[None] - cx) / fx
        yy = (yy[None] - cy) / fy
        zz = np.ones_like(xx + yy)
        dirs = np.stack(np.broadcast_arrays(xx, yy, zz), axis=-1)  # OpenCV
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = dirs.reshape(dirs.shape[0], -1, 3)
        if dirs.shape[0] == 1:
            dirs = np.broadcast_to(dirs, (self.n_images,) + dirs.shape[1:])
        dirs = (self.c2w[:, None, :3, :3] @ dirs[..., None])[..., 0]

        if factor != 1:
            import cv2

            gt = np.stack(
                [cv2.resize(im, (self.w, self.h), interpolation=cv2.INTER_AREA) for im in self.gt]
            )
        else:
            gt = self.gt
        gt = gt.reshape(self.n_images, -1, 3)
        origins = np.broadcast_to(self.c2w[:, None, :3, 3], (self.n_images, self.h * self.w, 3))
        mask = None
        if self.masks is not None:
            mask = self.masks.reshape(self.n_images, -1)

        if self.split == "train":
            origins = origins.reshape(-1, 3)
            dirs = dirs.reshape(-1, 3)
            gt = gt.reshape(-1, 3)
            if mask is not None:
                mask = mask.reshape(-1)

        self.rays_init = RayBatch(
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(gt, np.float32),
            mask,
        )
        self.rays = self.rays_init

    def to_device(self, device="cuda"):
        """Copy the whole train ray table to ``device`` once, as tensors of
        the table's own dtypes: ``rays_dev`` holds origins, dirs, gt and,
        for masked datasets, mask."""
        dev = resolve_device(device)
        r = self.rays_init
        self.rays_dev = {
            "origins": torch.as_tensor(r.origins, device=dev),
            "dirs": torch.as_tensor(r.dirs, device=dev),
            "gt": torch.as_tensor(r.gt, device=dev),
        }
        if r.mask is not None:
            self.rays_dev["mask"] = torch.as_tensor(r.mask, device=dev)
        return self

    def shuffle_perm(self, rng: np.random.Generator) -> np.ndarray:
        """The next epoch's ray order, drawn as the JAX package's
        ``shuffle_rays`` draws it (svox2's select_or_shuffle_rays,
        opt/util/util.py:80-99)."""
        n = len(self.rays_init)
        perm = rng.permutation(n) if self.permutation else rng.integers(0, n, self.epoch_size or n)
        if self.epoch_size is not None:
            perm = perm[: self.epoch_size]
        return perm

    def shuffle_rays(self, rng: np.random.Generator):
        """Epoch reshuffle of the host ray table."""
        if self.split != "train":
            return
        self.rays = self.rays_init[self.shuffle_perm(rng)]
