"""Whole-image rendering in fixed-size ray chunks, the counterpart of
the JAX package's ``render.image`` (svox2's ``volume_render_image``,
svox2.py:3641-3691, and ``volume_render_depth``, svox2.py:3693-3772).

Surface grids render through the packed renderer, with the occupancy words
and the packed grid rows built once per image and shared by every chunk;
its pool is sized exactly, so no chunk is re-rendered for overflow. Grids
without a surface (cuvol) render through the dense fixed-step march, as the
JAX package does (image.py:64). A partial tail chunk re-renders the last
``chunk`` rays ending at the image's end, as the JAX package does.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.grid import SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Camera, Rays
from .cuvol import volume_render_cuvol
from .surface import occupancy_words, pack_grid_data, volume_render_surface_packed


@torch.no_grad()
def render_rays(grid: SparseGrid, rays: Rays, opt: RenderOptions, chunk: int = 16384):
    """rgb (N, 3) and depth (N,) of ``rays`` on the grid's device, in the
    grid's dtype, ``chunk`` rays at a time."""
    n = rays.origins.shape[0]
    chunk = min(chunk, n)
    dtype, dev = grid.dtype, grid.links.device
    surface = grid.surface_data is not None
    if surface:
        occ = occupancy_words(grid, opt)
        packed = pack_grid_data(grid)
    rgb_out = torch.empty((n, 3), dtype=dtype, device=dev)
    depth_out = torch.empty(n, dtype=dtype, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        s_eff = e - chunk  # the tail chunk overlaps; overlap rows are rewritten
        r = Rays(rays.origins[s_eff:e].to(dtype), rays.dirs[s_eff:e].to(dtype))
        if surface:
            out = volume_render_surface_packed(grid, r, opt, occupancy=occ, packed=packed)
        else:
            out = volume_render_cuvol(grid, r, opt)
        rgb_out[s_eff:e] = out["rgb"]
        depth_out[s_eff:e] = out["depth"]
    return rgb_out, depth_out


def volume_render_depth(grid: SparseGrid, rays: Rays, opt: RenderOptions,
                        sigma_thresh: float | None = None, depth_type: str = "mean",
                        entries_per_ray: float = 16.0) -> torch.Tensor:
    """Depth of each ray in grid-t units (image.py:70-103): the expected
    ('mean'), max-weight ('mode') or median ('med') termination, or with
    ``sigma_thresh`` the first sample whose sigma (cuvol) or alpha (surface)
    exceeds it. Surface grids render through the packed renderer, cuvol
    grids through the dense march."""
    if grid.surface_data is not None:
        out = volume_render_surface_packed(grid, rays, opt, entries_per_ray=entries_per_ray,
                                           depth_sigma_thresh=sigma_thresh)
        return {"mode": out["depth_mode"], "med": out["depth_med"]}.get(depth_type, out["depth"])
    out = volume_render_cuvol(grid, rays, opt, depth_sigma_thresh=sigma_thresh)
    if sigma_thresh is not None:
        return out["depth_sigma_thresh"]
    if depth_type != "mean":
        raise NotImplementedError(f"depth_type {depth_type!r} for the cuvol backend")
    return out["depth"]


@torch.no_grad()
def render_image(
    grid: SparseGrid,
    camera: Camera,
    opt: RenderOptions,
    chunk: int = 16384,
    return_depth: bool = False,
    device="cuda",
):
    """Render a full camera image on ``device``; returns (H, W, 3) numpy
    float32, and the (H, W) depth as well with ``return_depth``. Rays are
    generated on the device in float32, as the JAX package does."""
    dev = resolve_device(device)
    if grid.links.device != dev:
        raise ValueError(f"the grid lies on {grid.links.device}, not on {dev}")
    rgb, depth = render_rays(grid, camera.gen_rays_device(dev), opt, chunk)
    H, W = camera.height, camera.width
    img = rgb.reshape(H, W, 3).float().cpu().numpy()
    if return_depth:
        return img, depth.reshape(H, W).float().cpu().numpy()
    return img
