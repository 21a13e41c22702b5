"""Dataset registry, the counterpart of the JAX package's ``data``
(svox2's opt/util/dataset.py:8-33). Only the procedural synthetic dataset
is ported; the file loaders wait for ROADMAP §1 item 6."""
from .base import DatasetBase, Intrin, RayBatch
from .synthetic import SyntheticDataset


def _unported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} dataset loader is not ported yet (ROADMAP §1 item 6)")

    return make


datasets = {
    "synthetic": SyntheticDataset,
    **{k: _unported(k) for k in ("auto", "nerf", "llff", "dtu", "nsvf", "co3d")},
}

__all__ = ["DatasetBase", "Intrin", "RayBatch", "SyntheticDataset", "datasets"]
