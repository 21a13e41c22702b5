"""Export a density/SH grid as an svox (v1) N3Tree checkpoint, the
counterpart of the JAX package's ``geometry.svox1`` (svox2's
``SparseGrid.to_svox1``, svox2.py:4840-4888), host numpy as there.

The octree is built directly in N3Tree's .npz layout (``data_dim``,
``data_format``, ``invradius3``, ``offset``, ``child``, ``data``):
branching factor 2, a node refined wherever its 2x2x2 block holds an
occupied voxel, leaf data (3 basis_dim SH coefficients | density) in
float16, ``child`` the relative offsets of the child nodes. Only cubic
power-of-two density grids; surface grids raise, as svox2 does."""
from __future__ import annotations

import numpy as np

from ..core.grid import SparseGrid


def to_svox1_npz(grid: SparseGrid, out_path: str) -> dict:
    """Write ``grid`` to ``out_path`` as an N3Tree npz; returns
    {"n_nodes", "data_dim"}."""
    reso = tuple(grid.links.shape)
    assert reso[0] == reso[1] == reso[2], "grid must be cubic"
    L = int(np.log2(reso[0]))
    assert 2 ** L == reso[0], "grid must be power-of-two"
    if grid.surface_data is not None:
        raise NotImplementedError("surface grids cannot be exported to svox1 (svox2.py:4886)")

    links = grid.links.detach().cpu().numpy()
    sh = grid.sh_data.detach().cpu().numpy().astype(np.float32)
    density = grid.density_data.detach().cpu().numpy().astype(np.float32)
    data_dim = sh.shape[1] + 1

    # occupancy pyramid: occ[l] has side 2^l (l = L is the voxel level)
    occ = [None] * (L + 1)
    occ[L] = links >= 0
    for lev in range(L - 1, -1, -1):
        s = occ[lev + 1]
        n = s.shape[0] // 2
        occ[lev] = s.reshape(n, 2, n, 2, n, 2).any(axis=(1, 3, 5))

    # the nodes breadth first, as the JAX package's queue visits them: a node
    # at depth d covers a block of side 2^(L-d); its 8 cells (in (cx, cy, cz)
    # order) that are occupied and of side > 1 become the next level's nodes,
    # in their parents' order; the cells of side 1 are voxels (leaf data).
    # Level by level in numpy, where the JAX package loops in Python.
    offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(8, 3)
    levels = [np.zeros((1, 3), np.int64)]  # block coords of the nodes at each depth
    masks = []  # per depth below L - 1: which of the (n_d * 8) cells are nodes
    for d in range(L - 1):
        cand = (2 * levels[d][:, None, :] + offs[None]).reshape(-1, 3)
        m = occ[d + 1][cand[:, 0], cand[:, 1], cand[:, 2]]
        masks.append(m)
        levels.append(cand[m])
    starts = np.cumsum([0] + [len(b) for b in levels])
    N = int(starts[-1])
    child = np.zeros((N, 8), np.int32)
    for d, m in enumerate(masks):
        parent = starts[d] + np.repeat(np.arange(len(levels[d])), 8)
        kid = starts[d + 1] + np.cumsum(m) - 1
        child[starts[d]:starts[d + 1]] = np.where(m, kid - parent, 0).reshape(-1, 8)
    data = np.zeros((N, 8, data_dim), np.float16)
    if L >= 1:
        d = L - 1
        vox = (2 * levels[d][:, None, :] + offs[None]).reshape(-1, 3)
        lk = links[vox[:, 0], vox[:, 1], vox[:, 2]]
        leaf = np.zeros((len(vox), data_dim), np.float32)
        leaf[lk >= 0, :-1] = sh[lk[lk >= 0]]
        leaf[lk >= 0, -1] = density[lk[lk >= 0], 0]
        data[starts[d]:starts[d + 1]] = leaf.reshape(-1, 8, data_dim)
    child = child.reshape(N, 2, 2, 2)
    data = data.reshape(N, 2, 2, 2, data_dim)

    radius = grid.radius.detach().cpu().numpy().astype(np.float32)
    center = grid.center.detach().cpu().numpy().astype(np.float32)
    np.savez_compressed(
        out_path,
        data_dim=np.int64(data_dim),
        data_format=f"SH{grid.basis_dim}",
        invradius3=0.5 / radius,
        offset=0.5 * (1.0 - center / radius),
        child=child,
        data=data,
    )
    return {"n_nodes": N, "data_dim": data_dim}
