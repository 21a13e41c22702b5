"""Whole-image rendering in fixed-size ray chunks, the counterpart of
the JAX package's ``render.image`` (svox2's ``volume_render_image``,
svox2.py:3641-3691, and ``volume_render_depth``, svox2.py:3693-3772).

Surface grids render through the renderer chosen by ``renderer``, as the
JAX package's (image.py:40-65): ``"packed"`` (the exact pool; no chunk is
ever re-rendered for overflow), ``"compact"`` (the first
``max_intersect_voxels`` occupied crossings of each ray; overflow is
counted, not grown, as JAX does) or ``"dense"`` (the DDA walk). The
occupancy words and the packed grid rows are built once per image and
shared by every chunk. Grids without a surface (cuvol) render through the
dense fixed-step march, as the JAX package does. A partial tail chunk
re-renders the last ``chunk`` rays ending at the image's end, as the JAX
package does.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.grid import SparseGrid
from ..core.options import RenderOptions
from ..core.rays import Camera, Rays
from .cuvol import volume_render_cuvol
from .surface import (
    RENDERERS, occupancy_words, pack_grid_data, volume_render_surface,
    volume_render_surface_compact, volume_render_surface_packed,
)


def _render_surface(grid, rays, opt, renderer, max_intersect_voxels, occ, packed):
    """One chunk through the chosen surface renderer: (out, overflow), the
    rays' occupied crossings beyond K for ``compact``, else 0."""
    if renderer == "packed":
        return volume_render_surface_packed(grid, rays, opt, occupancy=occ, packed=packed), 0
    if renderer == "compact":
        out = volume_render_surface_compact(grid, rays, opt, max_intersect_voxels=max_intersect_voxels,
                                            occupancy=occ, packed=packed)
        return out, torch.clamp(out["n_occupied"] - max_intersect_voxels, min=0).sum()
    return volume_render_surface(grid, rays, opt, occupancy=occ, packed=packed), 0


@torch.no_grad()
def render_rays(grid: SparseGrid, rays: Rays, opt: RenderOptions, chunk: int = 16384,
                renderer: str = "packed", max_intersect_voxels: int = 64, stats: dict | None = None):
    """rgb (N, 3), depth (N,) and normal (N, 3) of ``rays`` on the grid's
    device, in the grid's dtype, ``chunk`` rays at a time. ``stats``, if
    given, gets ``overflow``: the occupied crossings the compact renderer
    left out over all chunks (a tensor on the grid's device)."""
    if renderer not in RENDERERS:
        raise ValueError(f"renderer {renderer!r}; one of {RENDERERS}")
    n = rays.origins.shape[0]
    chunk = min(chunk, n)
    dtype, dev = grid.dtype, grid.links.device
    surface = grid.surface_data is not None
    occ = packed = None
    if surface:
        # the dense walk reads the words too: K11a lists only occupied voxels
        occ = occupancy_words(grid, opt)
        packed = pack_grid_data(grid)
    rgb_out = torch.empty((n, 3), dtype=dtype, device=dev)
    depth_out = torch.empty(n, dtype=dtype, device=dev)
    normal_out = torch.zeros((n, 3), dtype=dtype, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        s_eff = e - chunk  # the tail chunk overlaps; overlap rows are rewritten
        r = Rays(rays.origins[s_eff:e].to(dtype), rays.dirs[s_eff:e].to(dtype))
        if surface:
            out, over = _render_surface(grid, r, opt, renderer, max_intersect_voxels, occ, packed)
            normal_out[s_eff:e] = out["normal"]
            overflow = overflow + over
        else:
            out = volume_render_cuvol(grid, r, opt)
        rgb_out[s_eff:e] = out["rgb"]
        depth_out[s_eff:e] = out["depth"]
    if stats is not None:
        stats["overflow"] = overflow
    return rgb_out, depth_out, normal_out


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
        if sigma_thresh is not None:
            return out["depth_sigma_thresh"]
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
    return_normal: bool = False,
    renderer: str = "packed",
    max_intersect_voxels: int = 64,
    compact: bool | None = None,
    device="cuda",
    stats: dict | None = None,
):
    """Render a full camera image on ``device``; returns (H, W, 3) numpy
    float32, plus the (H, W) depth and (H, W, 3) normal as requested.
    ``compact`` is the JAX package's back-compat switch (True: "compact",
    False: "dense"). Rays are generated on the device in float32, as the
    JAX package does. ``stats`` gets the compact renderer's ``overflow``."""
    if compact is not None:
        renderer = "compact" if compact else "dense"
    dev = resolve_device(device)
    if grid.links.device != dev:
        raise ValueError(f"the grid lies on {grid.links.device}, not on {dev}")
    rgb, depth, normal = render_rays(grid, camera.gen_rays_device(dev), opt, chunk, renderer,
                                     max_intersect_voxels, stats)
    H, W = camera.height, camera.width
    outs = (rgb.reshape(H, W, 3).float().cpu().numpy(),)
    if return_depth:
        outs += (depth.reshape(H, W).float().cpu().numpy(),)
    if return_normal:
        outs += (normal.reshape(H, W, 3).float().cpu().numpy(),)
    return outs if len(outs) > 1 else outs[0]
