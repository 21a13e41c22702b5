"""NSVF-layout dataset loader (Tanks and Temples ships in it), the
counterpart of the JAX package's ``data.nsvf`` (svox2's
opt/util/nsvf_dataset.py): one pose file per image under ``pose/``, the
split told by the image's prefix (``0_`` train, ``1_`` val, ``2_`` test),
the scene normalised by the cameras (``similarity_from_cameras``,
opt/util/util.py:389-443, then ``cam_scale_factor``) or by ``bbox.txt``,
and one ``intrinsics.txt`` for every image. Its scenes have a background,
which the MSI spheres model: ``should_use_background`` is True.

The PNGs go through ``utils.png`` (the machine with the card has no image
library), and a ``scale`` below 1 through ``data.base.area_resize``,
OpenCV's INTER_AREA on the 8-bit image.
"""
from __future__ import annotations

import os
from os import path
from typing import Optional

import numpy as np

from ..utils.png import read_png
from .base import DatasetBase, Intrin, area_resize


def similarity_from_cameras(c2w: np.ndarray):
    """The similarity transform (4x4, scale) that normalises an OpenCV c2w
    set: the mean up vector to -y, the point nearest all optical axes to the
    origin, the median camera distance to 1 (opt/util/util.py:389-443)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]
    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)
    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [[0.0, -cross[2], cross[1]], [cross[2], 0.0, -cross[0]], [-cross[1], cross[0], 0.0]]
    )
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.diag([-1.0, 1.0, 1.0])
    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]
    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)
    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align
    scale = 1.0 / np.median(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


def sort_key(name: str) -> str:
    """Files sort by their name without the split prefix ("0_", "1_", ...)."""
    return name[2:] if len(name) > 2 and name[1] == "_" else name


def _look_for_dir(root: str, cands) -> str:
    for c in cands:
        if path.isdir(path.join(root, c)):
            return c
    raise AssertionError(f"none of {cands} in {root}")


class NSVFDataset(DatasetBase):
    def __init__(
        self,
        root: str,
        split: str,
        epoch_size: Optional[int] = None,
        scene_scale: Optional[float] = None,
        factor: int = 1,
        scale: Optional[float] = 1.0,
        permutation: bool = True,
        white_bkgd: bool = True,
        normalize_by_bbox: bool = False,
        data_bbox_scale: float = 1.1,
        cam_scale_factor: float = 0.95,
        normalize_by_camera: bool = True,
        **kwargs,
    ):
        super().__init__()
        assert path.isdir(root), f"'{root}' is not a directory"
        scale = 1.0 if scale is None else scale
        self.permutation = permutation
        self.epoch_size = epoch_size
        self.split = split

        img_dir = _look_for_dir(root, ["images", "image", "rgb"])
        pose_dir = _look_for_dir(root, ["poses", "pose"])
        img_files = sorted(os.listdir(path.join(root, img_dir)), key=sort_key)
        if split in ("train", "test_train"):
            sel = [x for x in img_files if x.startswith("0_")]
        elif split == "val":
            sel = [x for x in img_files if x.startswith("1_")]
        else:
            sel = [x for x in img_files if x.startswith("2_")] or [
                x for x in img_files if x.startswith("1_")
            ]
        img_files = sel or img_files
        assert img_files, f"no images in {root}/{img_dir}"

        all_c2w, all_gt = [], []
        for fn in img_files:
            im = read_png(path.join(root, img_dir, fn))
            pose = np.loadtxt(
                path.join(root, pose_dir, path.splitext(fn)[0] + ".txt")
            ).reshape(-1, 4)
            if len(pose) == 3:
                pose = np.concatenate([pose, [[0, 0, 0, 1.0]]], 0)
            if scale < 1.0:
                h, w = im.shape[:2]
                im = area_resize(im, (round(w * scale), round(h * scale)))
            all_c2w.append(pose)
            all_gt.append(im)
        c2w = np.stack(all_c2w)

        if normalize_by_bbox and path.exists(path.join(root, "bbox.txt")):
            bbox = np.loadtxt(path.join(root, "bbox.txt"))
            center = (bbox[:3] + bbox[3:6]) * 0.5
            radius = (bbox[3:6] - bbox[:3]) * 0.5 * data_bbox_scale
            c2w[:, :3, 3] -= center
            scene_scale = 1.0 / radius.max()
        elif normalize_by_camera:
            # every pose file, whatever its split, as the JAX loader reads them
            norm_files = sorted(os.listdir(path.join(root, pose_dir)), key=sort_key)
            norm_poses = np.stack(
                [np.vstack([np.loadtxt(path.join(root, pose_dir, x)).reshape(-1, 4)[:3],
                            [0, 0, 0, 1.0]])
                 for x in norm_files]
            )
            T, sscale = similarity_from_cameras(norm_poses)
            c2w = T @ c2w
            scene_scale = cam_scale_factor * sscale
        elif scene_scale is None:
            scene_scale = 1.0
        c2w[:, :3, 3] *= scene_scale
        self.c2w = c2w.astype(np.float32)
        self.scene_scale = scene_scale

        gt = np.stack(all_gt).astype(np.float32) / 255.0
        if gt.shape[-1] == 4:
            if white_bkgd:
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            else:
                gt = gt[..., :3]
        self.gt = gt
        self.n_images, self.h_full, self.w_full, _ = gt.shape

        K = np.loadtxt(path.join(root, "intrinsics.txt"), ndmin=2)
        if K.shape[0] >= 3:
            fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        else:
            fx = fy = K[0, 0]
            cx, cy = K[0, 1], K[0, 2]
        self.intrins_full = Intrin(fx * scale, fy * scale, cx * scale, cy * scale)
        self.should_use_background = True
        if split == "train":
            self.gen_rays(factor=factor)
        else:
            self.h, self.w = self.h_full, self.w_full
            self.intrins = self.intrins_full
