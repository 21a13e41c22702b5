"""numpy grids for the tests of K6's every-cell and windowed modes
(``tests/test_torch_reg_present.py`` on the CPU, ``tests/test_torch_cuda_reg.py``
on the card). Imports nothing of JAX."""
import numpy as np


def shell_arrays(reso, seed: int = 0, prune: float = 0.2, orphans: int = 0, unlink: int = 0,
                 link000: bool = False, dense: bool = False, channels: int = 27,
                 dtype=np.float64) -> dict:
    """Arrays of a sparse SDF shell on a ``reso`` (X, Y, Z) lattice, rows in
    flat order: the vertices within 0.35 of radius 0.6 of the box's
    half-widths (every vertex with ``dense``), a ``prune`` share dropped at
    random. ``link000`` links vertex (0, 0, 0) too; ``unlink`` unlinks that
    many present vertices after numbering (their rows stay, linked by
    nothing) and ``orphans`` rows are appended that no link names: then
    the capacity exceeds the present links. Raw alpha 2 N(0, 1) + 1,
    ``channels`` SH channels 0.3 N(0, 1), the surface the signed distance
    to the radius plus 0.05 N(0, 1), two level sets."""
    rng = np.random.default_rng(seed)
    reso = tuple(int(r) for r in reso)
    idx = np.stack(np.meshgrid(*[np.arange(r) for r in reso], indexing="ij"), -1).reshape(-1, 3)
    half = np.array(reso, np.float64) / 2.0
    r = np.linalg.norm((idx - half) / half, axis=-1)
    keep = np.ones(len(idx), bool) if dense else np.abs(r - 0.6) < 0.35
    keep &= rng.random(len(idx)) >= prune
    if link000:
        keep[0] = True
    n_linked = int(keep.sum())
    links = np.full(len(idx), -1, np.int32)
    links[keep] = np.arange(n_linked, dtype=np.int32)
    if unlink:
        on = np.nonzero(links >= 0)[0]
        links[rng.choice(on[1:], unlink, replace=False)] = -1
    cap = n_linked + orphans
    surf = np.concatenate([0.6 - r[keep], rng.standard_normal(orphans)])[:, None]
    return {
        "links": links.reshape(reso),
        "density_data": (rng.standard_normal((cap, 1)) * 2.0 + 1.0).astype(dtype),
        "sh_data": (rng.standard_normal((cap, channels)) * 0.3).astype(dtype),
        "surface_data": (surf + rng.standard_normal((cap, 1)) * 0.05).astype(dtype),
        "level_set_data": np.array([0.0, 0.1], dtype),
        "fake_sample_std": np.full((1, 1), 0.4, dtype),
        "truncated_vol_render_a": np.asarray(1.5, dtype),
        "radius": np.ones(3, dtype),
        "center": np.zeros(3, dtype),
        "basis_dim": max(channels // 3, 1),
        "surface_type": 0,  # SDF
    }


def row_coords(links: np.ndarray, capacity: int) -> np.ndarray:
    """(capacity, 3) int32 lattice coordinates of each row, (0, 0, 0) for a
    row no link names: reg.row_coords_of in numpy."""
    X, Y, Z = links.shape
    flat = links.reshape(-1)
    pos = np.nonzero(flat >= 0)[0]
    out = np.zeros((capacity, 3), np.int32)
    out[flat[pos]] = np.stack([pos // (Y * Z), (pos // Z) % Y, pos % Z], -1)
    return out
