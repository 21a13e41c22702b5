"""Dataset registry, the counterpart of the JAX package's ``data``
(svox2's opt/util/dataset.py:8-33): the procedural synthetic dataset, the
NeRF-synthetic (Blender) loader and the DTU loader. ``auto`` tells a scene
by its files in the JAX package's order; the LLFF, NSVF and CO3D loaders
wait for ROADMAP §1 items 2 and 5."""
from os import path

from .base import DatasetBase, Intrin, RayBatch
from .dtu import DTUDataset
from .nerf import NeRFDataset
from .synthetic import SyntheticDataset


def _unported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} dataset loader is not ported yet (ROADMAP §1 items 2 and 5)")

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
    return datasets["nsvf"](root, *args, **kwargs)


datasets = {
    "auto": auto_dataset,
    "nerf": NeRFDataset,
    "synthetic": SyntheticDataset,
    "dtu": DTUDataset,
    **{k: _unported(k) for k in ("llff", "nsvf", "co3d")},
}

__all__ = ["DatasetBase", "DTUDataset", "Intrin", "NeRFDataset", "RayBatch", "SyntheticDataset",
           "auto_dataset", "datasets"]
