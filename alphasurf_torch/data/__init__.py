"""Dataset registry, the counterpart of the JAX package's ``data``
(svox2's opt/util/dataset.py:8-33): the procedural synthetic dataset, the
NeRF-synthetic (Blender), DTU and NSVF loaders. ``auto`` tells a scene by
its files in the JAX package's order, NSVF last; the LLFF loader waits for
ROADMAP §1 item 4 (with a JPEG decoder of the port's own), CO3D for §1
item 5."""
from os import path

from .base import DatasetBase, Intrin, RayBatch
from .dtu import DTUDataset
from .nerf import NeRFDataset
from .nsvf import NSVFDataset
from .synthetic import SyntheticDataset


def _unported(name: str, item: int, why: str = ""):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} dataset loader is not ported yet (ROADMAP §1 item {item}{why})")

    return make


def auto_dataset(root: str, *args, **kwargs):
    """The loader of the scene in ``root``, told by its files as the JAX
    package's ``auto_dataset`` tells them (data/__init__.py:9-26)."""
    if path.isfile(path.join(root, "poses_bounds.npy")):
        return datasets["llff"](root, *args, **kwargs)
    if path.isfile(path.join(root, "transforms_train.json")) or path.isfile(
            path.join(root, "transforms.json")):
        return NeRFDataset(root, *args, **kwargs)
    if path.isfile(path.join(root, "cameras_sphere.npz")) or path.isfile(
            path.join(root, "cameras_large.npz")):
        return DTUDataset(root, *args, **kwargs)
    return NSVFDataset(root, *args, **kwargs)


datasets = {
    "auto": auto_dataset,
    "nerf": NeRFDataset,
    "synthetic": SyntheticDataset,
    "dtu": DTUDataset,
    "nsvf": NSVFDataset,
    "llff": _unported("llff", 4),
    "co3d": _unported("co3d", 5, ": it reads JPEG frames, and the port has no JPEG decoder yet"),
}

__all__ = ["DatasetBase", "DTUDataset", "Intrin", "NeRFDataset", "NSVFDataset", "RayBatch",
           "SyntheticDataset", "auto_dataset", "datasets"]
