"""Sparse voxel grid, the counterpart of the JAX package's ``core.grid``.

svox2's two-level storage: a dense ``links`` int32 index grid maps each
vertex to a data row, or -1 where the vertex is empty. ``SparseGrid`` is an
``nn.Module``: ``links`` and the geometry are buffers; density, surface and
SH rows are parameters (frozen here; the training slice unfreezes them).

Geometry conventions follow svox2: world2grid/grid2world svox2.py:4492-4522,
offset/scaling svox2.py:644-645.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import defs
from .device import resolve_device
from .sh import BasisMLP

# Corner offsets in reference order (z fastest): 000,001,010,011,100,101,110,111
CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [0, 1, 1],
        [1, 0, 0],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ],
    dtype=np.int32,
)


def _param(x):
    return None if x is None else nn.Parameter(x, requires_grad=False)


def _mlp(x, device=None, dtype=None):
    """A ``BasisMLP`` from one, from a dict of its four arrays, or None."""
    if x is None or isinstance(x, BasisMLP):
        return x
    return BasisMLP.from_dict(x, device=device, dtype=dtype)


class SparseGrid(nn.Module):
    """links (X, Y, Z) int32; density_data (cap, 1); sh_data
    (cap, 3*basis_dim); surface_data (cap, 1) or None; level_set_data
    (n_lv,) or None; fake_sample_std (1, 1) or None;
    truncated_vol_render_a (); radius/center (3,); the MSI background
    (svox2.py:731-755): background_links (2R, R) int32 and background_data
    (n, nlayers, 4) rgba rows, both or neither; the learned bases
    (svox2.py:963-976): basis_data (R, R, R, basis_dim) of a 3D-texture
    grid and basis_mlp (a ``core.sh.BasisMLP``, or a dict of its ``w0``,
    ``b0``, ``w1``, ``b1``) of an MLP grid, each None otherwise."""

    def __init__(
        self,
        links: torch.Tensor,
        density_data: torch.Tensor,
        sh_data: torch.Tensor,
        surface_data: torch.Tensor | None,
        level_set_data: torch.Tensor | None,
        fake_sample_std: torch.Tensor | None,
        truncated_vol_render_a: torch.Tensor,
        radius: torch.Tensor,
        center: torch.Tensor,
        basis_dim: int = 9,
        surface_type: int = defs.SURFACE_TYPE_NONE,
        basis_type: int = defs.BASIS_TYPE_SH,
        background_links: torch.Tensor | None = None,
        background_data: torch.Tensor | None = None,
        basis_data: torch.Tensor | None = None,
        basis_mlp=None,
    ):
        super().__init__()
        if (background_links is None) != (background_data is None):
            raise ValueError("background_links and background_data come together")
        self.register_buffer("links", links)
        self.density_data = _param(density_data)
        self.sh_data = _param(sh_data)
        self.surface_data = _param(surface_data)
        self.fake_sample_std = _param(fake_sample_std)
        self.register_buffer("level_set_data", level_set_data)
        self.register_buffer("truncated_vol_render_a", truncated_vol_render_a)
        self.register_buffer("radius", radius)
        self.register_buffer("center", center)
        self.register_buffer("background_links", background_links)
        self.background_data = _param(background_data)
        self.basis_data = _param(basis_data)
        self.basis_mlp = _mlp(basis_mlp, device=links.device, dtype=sh_data.dtype)
        self.basis_dim = int(basis_dim)
        self.surface_type = int(surface_type)
        self.basis_type = int(basis_type)

    # ---- weights carried across packages ----
    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda", dtype=None) -> "SparseGrid":
        """Build from numpy arrays keyed by the JAX field names. ``dtype``
        defaults to float64 for float64 ``density_data``, else float32."""
        dev = resolve_device(device)
        if dtype is None:
            f64 = np.asarray(arrays["density_data"]).dtype == np.float64
            dtype = torch.float64 if f64 else torch.float32

        def t(name, default=None):
            v = arrays.get(name, default)
            if v is None:
                return None
            return torch.tensor(np.asarray(v), dtype=dtype, device=dev)

        return cls(
            links=torch.tensor(np.asarray(arrays["links"], np.int32), device=dev),
            density_data=t("density_data"),
            sh_data=t("sh_data"),
            surface_data=t("surface_data"),
            level_set_data=t("level_set_data"),
            fake_sample_std=t("fake_sample_std"),
            truncated_vol_render_a=t("truncated_vol_render_a", 1.0),
            radius=t("radius"),
            center=t("center"),
            basis_dim=int(arrays.get("basis_dim", 9)),
            surface_type=int(arrays.get("surface_type", defs.SURFACE_TYPE_NONE)),
            basis_type=int(arrays.get("basis_type", defs.BASIS_TYPE_SH)),
            background_links=None if arrays.get("background_links") is None else torch.tensor(
                np.asarray(arrays["background_links"], np.int32), device=dev),
            background_data=t("background_data"),
            basis_data=t("basis_data"),
            basis_mlp=_mlp(arrays.get("basis_mlp"), device=dev, dtype=dtype),
        )

    def to_numpy(self) -> dict:
        """numpy arrays keyed by the JAX field names (None where absent)."""

        def a(x):
            return None if x is None else x.detach().cpu().numpy()

        return {
            "links": a(self.links),
            "density_data": a(self.density_data),
            "sh_data": a(self.sh_data),
            "surface_data": a(self.surface_data),
            "level_set_data": a(self.level_set_data),
            "fake_sample_std": a(self.fake_sample_std),
            "truncated_vol_render_a": a(self.truncated_vol_render_a),
            "radius": a(self.radius),
            "center": a(self.center),
            "basis_dim": self.basis_dim,
            "surface_type": self.surface_type,
            "basis_type": self.basis_type,
            "background_links": a(self.background_links),
            "background_data": a(self.background_data),
            "basis_data": a(self.basis_data),
            "basis_mlp": None if self.basis_mlp is None else self.basis_mlp.to_numpy(),
        }

    def replace(self, **fields) -> "SparseGrid":
        """A new grid with ``fields`` replaced (the JAX package's
        ``grid.replace``); the other tensors are shared, detached and
        contiguous."""
        keys = ("links", "density_data", "sh_data", "surface_data", "level_set_data",
                "fake_sample_std", "truncated_vol_render_a", "radius", "center",
                "background_links", "background_data", "basis_data")
        args = {}
        for k in keys:
            v = fields[k] if k in fields else getattr(self, k)
            args[k] = None if v is None else v.detach().contiguous()
        mlp = _mlp(fields["basis_mlp"] if "basis_mlp" in fields else self.basis_mlp,
                   device=self.links.device, dtype=self.sh_data.dtype)
        if mlp is not None:
            mlp = BasisMLP(*(v.detach().contiguous() for v in mlp.tensors().values()))
        return SparseGrid(**args, basis_mlp=mlp, basis_dim=self.basis_dim,
                          surface_type=fields.get("surface_type", self.surface_type),
                          basis_type=fields.get("basis_type", self.basis_type))

    @property
    def use_background(self) -> bool:
        return self.background_data is not None

    @property
    def background_nlayers(self) -> int:
        return 0 if self.background_data is None else self.background_data.shape[1]

    @property
    def background_reso(self) -> int:
        return 0 if self.background_links is None else self.background_links.shape[1]

    # ---- static geometry ----
    @property
    def reso(self) -> tuple:
        return tuple(self.links.shape)

    @property
    def capacity(self) -> int:
        return self.sh_data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.sh_data.dtype

    @property
    def gsz(self) -> torch.Tensor:
        """Grid size as a float tensor (X, Y, Z)."""
        return torch.tensor(self.reso, dtype=self.radius.dtype, device=self.radius.device)

    @property
    def offset(self) -> torch.Tensor:
        return 0.5 * (1.0 - self.center / self.radius)

    @property
    def scaling(self) -> torch.Tensor:
        return 0.5 / self.radius

    def world2grid(self, points: torch.Tensor) -> torch.Tensor:
        """World -> grid coords normalized to [0, n_voxels]. svox2.py:4492."""
        gsz = self.gsz
        return points * (self.scaling * gsz) + self.offset * gsz

    def grid2world(self, points: torch.Tensor) -> torch.Tensor:
        """Grid -> world coords. svox2.py:4508."""
        gsz = self.gsz
        roffset = -self.radius + self.center
        rscaling = 2.0 * self.radius / gsz
        return points * rscaling + roffset

    def within_grid(self, pts: torch.Tensor, atol: float = 1e-6) -> torch.Tensor:
        """Whether grid-space pts lie inside the vertex lattice. svox2.py:1443."""
        gsz = self.gsz
        return torch.all(pts <= gsz - 1.0 - atol, dim=-1) & torch.all(pts >= atol, dim=-1)


def create_grid(
    reso=128,
    radius=1.0,
    center=(0.0, 0.0, 0.0),
    basis_dim: int = 9,
    surface_type: int = defs.SURFACE_TYPE_NONE,
    surface_init: str | None = None,
    use_sphere_bound: bool = False,
    trainable_fake_sample_std: bool = False,
    init_sigma: float = 0.1,
    init_rgb: float = 0.0,
    dtype=torch.float32,
    device="cuda",
    basis_type: int = defs.BASIS_TYPE_SH,
    basis_data: torch.Tensor | None = None,
    basis_mlp=None,
) -> SparseGrid:
    """A dense grid on ``device``, all links present or, with
    ``use_sphere_bound``, the vertices within the unit sphere's bound
    (the JAX package's ``core.grid.create_grid``, svox2.py:580-990). The
    mask is computed in float32 numpy, as the JAX package does, so both
    keep the same vertices. Only ``SURFACE_TYPE_NONE`` grids: the surface
    initialisers wait for ROADMAP §1 item 5. ``basis_type`` with
    ``basis_data`` (a 3D texture, ``core.sh.reinit_learned_bases``) or
    ``basis_mlp`` (``core.sh.init_basis_mlp``) gives the grid a learned
    basis, as the JAX package's ``grid.replace`` does after
    ``create_grid``."""
    if surface_type != defs.SURFACE_TYPE_NONE:
        raise NotImplementedError(
            f"create_grid's surface initialisers (surface_type {surface_type}, surface_init "
            f"{surface_init!r}) are not ported yet (ROADMAP §1 item 5)")
    dev = resolve_device(device)
    if isinstance(reso, int):
        reso = (reso, reso, reso)
    reso = tuple(int(r) for r in reso)
    radius = np.broadcast_to(np.asarray(radius, dtype=np.float32), (3,)).copy()
    center = np.broadcast_to(np.asarray(center, dtype=np.float32), (3,)).copy()
    n3 = int(np.prod(reso))
    if use_sphere_bound:
        # svox2.py:653-679: keep the vertices within the unit sphere's bound
        axes = [np.arange(r, dtype=np.float32) - 0.5 for r in reso]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        gsz = np.asarray(reso, dtype=np.float32)
        pts = pts * (2.0 / gsz) + (1.0 / gsz - 1.0)
        mask = np.linalg.norm(pts, axis=-1) <= 1.0 + (3**0.5) / gsz.max()
        del pts
        capacity = int(mask.sum())
        links = np.full(n3, -1, dtype=np.int32)
        links[mask] = np.arange(capacity, dtype=np.int32)
    else:
        capacity = n3
        links = np.arange(n3, dtype=np.int32)
    f = dict(dtype=dtype, device=dev)
    return SparseGrid(
        links=torch.as_tensor(links.reshape(reso), device=dev),
        density_data=torch.full((capacity, 1), float(init_sigma), **f),
        sh_data=torch.full((capacity, basis_dim * 3), float(init_rgb), **f),
        surface_data=None,
        level_set_data=None,
        fake_sample_std=torch.ones((1, 1), **f) if trainable_fake_sample_std else None,
        truncated_vol_render_a=torch.tensor(1.0, **f),
        radius=torch.as_tensor(radius, **f),
        center=torch.as_tensor(center, **f),
        basis_dim=basis_dim,
        surface_type=defs.SURFACE_TYPE_NONE,
        basis_type=basis_type,
        basis_data=None if basis_data is None else torch.as_tensor(basis_data, **f),
        basis_mlp=basis_mlp,
    )
