"""Dataset registry, the counterpart of the JAX package's ``data``
(svox2's opt/util/dataset.py:8-33): the procedural synthetic dataset and
the DTU loader; ``auto`` recognises DTU scenes. The other file loaders
(NeRF, LLFF, NSVF, CO3D) wait for ROADMAP §1 items 1, 2 and 5."""
from os import path

from .base import DatasetBase, Intrin, RayBatch
from .dtu import DTUDataset
from .synthetic import SyntheticDataset


def _unported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} dataset loader is not ported yet (ROADMAP §1 items 1, 2 and 5)")

    return make


def auto_dataset(root: str, *args, **kwargs):
    """The loader of the scene in ``root``, told by its files as the JAX
    package's ``auto_dataset`` tells them; only DTU scenes are ported."""
    if path.isfile(path.join(root, "cameras_sphere.npz")) or path.isfile(
            path.join(root, "cameras_large.npz")):
        return DTUDataset(root, *args, **kwargs)
    raise NotImplementedError(
        f"{root!r} is not a DTU scene, and the other file loaders are not ported yet "
        "(ROADMAP §1 items 1, 2 and 5)")


datasets = {
    "auto": auto_dataset,
    "synthetic": SyntheticDataset,
    "dtu": DTUDataset,
    **{k: _unported(k) for k in ("nerf", "llff", "nsvf", "co3d")},
}

__all__ = ["DatasetBase", "DTUDataset", "Intrin", "RayBatch", "SyntheticDataset",
           "auto_dataset", "datasets"]
