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
    keep the same vertices. A surface grid (``surface_type`` other than
    NONE) gets the rows of ``surface_init`` from ``init_surface``, bit for
    bit JAX's; a UDF_ALPHA grid's ``density_data`` is its (n_lv, 1) table of
    per-level-set alphas, zeros. ``basis_type`` with ``basis_data`` (a 3D
    texture, ``core.sh.reinit_learned_bases``) or ``basis_mlp``
    (``core.sh.init_basis_mlp``) gives the grid a learned basis, as the JAX
    package's ``grid.replace`` does after ``create_grid``."""
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
    density = torch.full((capacity, 1), float(init_sigma), **f)
    surface = level_sets = None
    if surface_type != defs.SURFACE_TYPE_NONE:
        surf_np, lv_np = init_surface(reso, links, capacity, surface_init, surface_type)
        surface = torch.as_tensor(surf_np, **f)
        level_sets = torch.as_tensor(lv_np, **f)
        if surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
            # one alpha per level set instead of per vertex (svox2.py:950-953)
            density = torch.zeros((lv_np.shape[0], 1), **f)
    return SparseGrid(
        links=torch.as_tensor(links.reshape(reso), device=dev),
        density_data=density,
        sh_data=torch.full((capacity, basis_dim * 3), float(init_rgb), **f),
        surface_data=surface,
        level_set_data=level_sets,
        fake_sample_std=torch.ones((1, 1), **f) if trainable_fake_sample_std else None,
        truncated_vol_render_a=torch.tensor(1.0, **f),
        radius=torch.as_tensor(radius, **f),
        center=torch.as_tensor(center, **f),
        basis_dim=basis_dim,
        surface_type=surface_type,
        basis_type=basis_type,
        basis_data=None if basis_data is None else torch.as_tensor(basis_data, **f),
        basis_mlp=basis_mlp,
    )


# the unsigned-distance types: softplus of the surface values, fixed level sets
UDF_TYPES = (defs.SURFACE_TYPE_UDF, defs.SURFACE_TYPE_UDF_ALPHA,
             defs.SURFACE_TYPE_UDF_FAKE_SAMPLE)
_NEAREST_CHUNK = 1 << 20  # lattice vertices a block of the nearest-sphere search


def _nearest_sphere(rs: np.ndarray, sphere_rs: np.ndarray) -> np.ndarray:
    """Per vertex, its signed distance to the nearest of the concentric
    spheres, the first on ties: the JAX package's argmin over its
    (n, n_spheres) distance matrix (7.5 GB at 256^3 with spheres every 4
    voxels). The radii are evenly spaced, so the nearest is one of the three
    around rs's position in them; those three distances, in index order,
    are computed as JAX's (rs - r), a block of rows at a time."""
    out = np.empty(rs.shape[0], np.float64)
    n = sphere_rs.shape[0]
    step = (sphere_rs[-1] - sphere_rs[0]) / max(n - 1, 1)
    for i0 in range(0, rs.shape[0], _NEAREST_CHUNK):
        r = rs[i0:i0 + _NEAREST_CHUNK]
        k = np.floor((r - sphere_rs[0]) / step).astype(np.int64) if n > 1 else np.zeros(
            r.shape, np.int64)
        cand = np.clip(k[:, None] + np.arange(-1, 3)[None, :], 0, n - 1)  # ascending indices
        dists = r[:, None] - sphere_rs[cand]
        out[i0:i0 + _NEAREST_CHUNK] = dists[np.arange(r.shape[0]), np.abs(dists).argmin(axis=-1)]
    return out


def init_surface(reso, links: np.ndarray, capacity: int, surface_init, surface_type):
    """The surface initialisers of the JAX package's ``core.grid._init_surface``
    (grid.py:211-314; svox2.py:770-961) in host numpy, in its order of
    operations and random draws, so that the rows are bit for bit JAX's.
    ``links`` is the flat int32 link array. Returns float32 numpy
    (surface (cap, C), level sets (n_lv,)); C is 4 for PLANE, 1 otherwise."""
    coords = np.stack(np.meshgrid(np.arange(reso[0]), np.arange(reso[1]), np.arange(reso[2]),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    grid_center = np.asarray(reso) / 2.0
    rs = np.sqrt(np.sum((coords - grid_center) ** 2, axis=-1))
    r_half = float(np.linalg.norm(grid_center))
    lnk = links.reshape(-1)
    valid = lnk >= 0
    rng = np.random.default_rng(0)
    level_sets = np.array([0.0], np.float32)
    data = np.zeros((capacity, 1), dtype=np.float32)

    if surface_type == defs.SURFACE_TYPE_PLANE:
        # per-vertex plane (a, b, c, d): ax + by + cz + d = 0 (svox2.py:850-884)
        data = np.zeros((capacity, 4), np.float32)
        if surface_init in (None, "random"):
            d4 = rng.random((capacity, 4), np.float32) - 0.5
            d4[:, :3] /= np.linalg.norm(d4[:, :3], axis=-1, keepdims=True)
            data = d4
        elif surface_init == "sphere":
            dirs = (coords - grid_center).astype(np.float32)
            n = np.linalg.norm(dirs, axis=-1, keepdims=True)
            dirs = np.where(n > 0, dirs / np.where(n == 0, 1, n), 1.0 / np.sqrt(3))
            data[lnk[valid], :3] = dirs[valid]
        else:
            raise ValueError(f"surface_init={surface_init!r} for PLANE grids")
        # the plane passes through its vertex (svox2.py:862-866)
        data[lnk[valid], 3] = -np.sum(coords[valid] * data[lnk[valid], :3], axis=-1)
        return data, level_sets

    if surface_type in UDF_TYPES:
        # an unsigned distance field with fixed level sets (svox2.py:885-949)
        if surface_init is None:
            level_sets = np.array([64.0], np.float32)
        elif surface_init == "sphere":
            data[lnk[valid], 0] = rs[valid]
            level_sets = (np.arange(0, r_half, 4) + 0.5).astype(np.float32)
        elif surface_init == "single_lv":
            level_sets = np.array([64.0], np.float32)
            data[lnk[valid], 0] = (rs - (r_half / 2.0 - level_sets[0]))[valid]
        elif surface_init == "single_lv_multi_sphere":
            level_sets = np.array([64.0], np.float32)
            nearest = _nearest_sphere(rs, np.arange(0, r_half, 4) + 0.5)
            data[lnk[valid], 0] = nearest[valid] + level_sets[0]
        else:
            raise ValueError(f"surface_init={surface_init!r} for UDF grids")
        return data, level_sets

    if surface_type == defs.SURFACE_TYPE_VOXEL_FACE:
        # zeros: the geometry is the voxels' faces (svox2.py:955-957)
        return data, level_sets

    # SDF (svox2.py:772-846)
    if surface_init is None:
        pass
    elif surface_init == "sphere":
        # concentric spheres every 2 voxels (svox2.py:779-793)
        data[lnk[valid], 0] = _nearest_sphere(rs, np.arange(0, r_half, 2) + 0.5)[valid]
    elif surface_init == "single_sphere":
        # one sphere of radius |grid_center| / 2, rescaled (svox2.py:808-820)
        data[lnk[valid], 0] = (rs - r_half / 2.0)[valid]
        data *= 10.0 / rs.max()
    elif surface_init == "outwards":
        # random magnitudes, the sign flipped in alternating shells (svox2.py:822-841)
        data[:, 0] = rng.random(capacity, np.float32)
        abs_max_axis = np.abs(coords - grid_center.astype(np.int64)).argmax(-1)
        for axis_id in range(3):
            sel = (abs_max_axis == axis_id) & (coords[:, axis_id] % 2 == 0) & valid
            data[lnk[sel], 0] *= -1.0
    elif surface_init == "plane_init":
        # noisy planes alternating along x (svox2.py:843-846)
        data[:, 0] = rng.random(capacity, np.float32) * 0.1 + 1.0
        sel = (coords[:, 0] % 2 == 1) & valid
        data[lnk[sel], 0] *= -1.0
    elif surface_init == "random":
        data[lnk[valid], 0] = rng.standard_normal(int(valid.sum())) * 0.1
    else:
        raise ValueError(f"surface_init={surface_init!r}")
    return data, level_sets
