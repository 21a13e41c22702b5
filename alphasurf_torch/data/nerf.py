"""NeRF-synthetic (Blender) dataset loader, the counterpart of the JAX
package's ``data.nerf`` (svox2's opt/util/nerf_dataset.py):
``transforms_{split}.json`` and its PNGs, the OpenGL -> OpenCV pose flip
(nerf_dataset.py:77-82), white-background compositing of RGBA images
(:104-109) and the scene scale 2/3 of the translations (:46-47).

The PNGs go through ``utils.png`` (the machine with the card has no image
library), and a ``scale`` below 1 through ``data.base.area_resize``,
OpenCV's INTER_AREA on the 8-bit image.
"""
from __future__ import annotations

import json
from os import path
from typing import Optional

import numpy as np

from ..utils.png import read_png
from .base import DatasetBase, Intrin, area_resize


class NeRFDataset(DatasetBase):
    def __init__(
        self,
        root: str,
        split: str,
        epoch_size: Optional[int] = None,
        scene_scale: Optional[float] = None,
        factor: int = 1,
        scale: Optional[float] = None,
        permutation: bool = True,
        white_bkgd: bool = True,
        n_images: Optional[int] = None,
        **kwargs,
    ):
        super().__init__()
        assert path.isdir(root), f"'{root}' is not a directory"
        scene_scale = 2 / 3 if scene_scale is None else scene_scale
        scale = 1.0 if scale is None else scale
        self.permutation = permutation
        self.epoch_size = epoch_size

        split_name = split if split != "test_train" else "train"
        data_path = path.join(root, split_name)
        with open(path.join(root, "transforms_" + split_name + ".json")) as f:
            j = json.load(f)

        cam_trans = np.diag(np.array([1, -1, -1, 1], dtype=np.float32))
        all_c2w, all_gt = [], []
        for frame in j["frames"]:
            fpath = path.join(data_path, path.basename(frame["file_path"]) + ".png")
            all_c2w.append(np.asarray(frame["transform_matrix"], dtype=np.float32) @ cam_trans)
            im = read_png(fpath)
            if scale < 1.0:
                h, w = im.shape[:2]
                im = area_resize(im, (round(w * scale), round(h * scale)))
            all_gt.append(im)

        focal = float(0.5 * all_gt[0].shape[1] / np.tan(0.5 * j["camera_angle_x"]))
        self.c2w = np.stack(all_c2w)
        self.c2w[:, :3, 3] *= scene_scale
        gt = np.stack(all_gt).astype(np.float32) / 255.0
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]) if white_bkgd else gt[..., :3]
        self.gt = gt
        self.n_images, self.h_full, self.w_full, _ = gt.shape
        if n_images is not None and n_images < self.n_images:
            self.n_images = n_images
            self.gt = self.gt[:n_images]
            self.c2w = self.c2w[:n_images]

        self.intrins_full = Intrin(focal, focal, self.w_full * 0.5, self.h_full * 0.5)
        self.split = split
        self.scene_scale = scene_scale
        self.should_use_background = False
        if split == "train":
            self.gen_rays(factor=factor)
        else:
            self.h, self.w = self.h_full, self.w_full
            self.intrins = self.intrins_full
