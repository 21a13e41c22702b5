"""alphasurf_torch — the PyTorch/CUDA port of the JAX package beside it.

A second package beside the JAX one, which stays the reference. Module
names follow the JAX package so each counterpart is easy to find. The
packed surface and cuvol renderers, their backward passes, the compat
marches (nvol, svox1), the regularizers, the optimizer and the stage
transitions (``core.topology``, ``core.weight_render``) run through hand-written CUDA kernels for Hopper
(``csrc/``, built at first use by ``kernels.py``); on CPU tensors every
kernel's plain PyTorch version runs instead. Entry points default to
``device="cuda"`` and raise when no card is present.
"""
from . import defs
from .core.grid import SparseGrid, create_grid
from .core.options import RenderOptions
from .core.rays import Camera, Rays
from .render.compat import volume_render, volume_render_nvol, volume_render_svox1
from .render.cuvol import volume_render_cuvol, volume_render_cuvol_packed
from .render.image import render_image
from .render.surface import volume_render_surface_packed

__all__ = [
    "defs",
    "SparseGrid",
    "create_grid",
    "RenderOptions",
    "Camera",
    "Rays",
    "render_image",
    "volume_render",
    "volume_render_cuvol",
    "volume_render_cuvol_packed",
    "volume_render_nvol",
    "volume_render_surface_packed",
    "volume_render_svox1",
]
