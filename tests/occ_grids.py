"""numpy grids for the tests of K1 and K1d, the occupancy words
(``tests/test_torch_occupancy_walk.py`` on the CPU, the occupancy tests of
``tests/test_torch_cuda.py`` on the card), and the card checks those run.
Imports nothing of JAX, so that the checks also run on a machine without
it:

    python -c "import sys; sys.path.insert(0, 'tests'); import occ_grids; occ_grids.check_card()"
"""
import numpy as np
import torch

from alphasurf_torch import defs, kernels
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.core.options import RenderOptions
from alphasurf_torch.render import cuvol as C
from alphasurf_torch.render import surface as S
from reg_grids import shell_arrays

# the surface types, by name
SURFACE_TYPES = {k: defs.SURFACE_TYPE_STRS[k]
                 for k in ("sdf", "plane", "udf", "udf_alpha", "udf_fake_sample", "voxel_face")}
# the option sets: the hull test with an alpha gate between the drawn
# alphas, no gate, and unrestricted fake samples (no hull)
OPTION_SETS = {
    "gate": dict(sigma_thresh=0.5),
    "open": dict(sigma_thresh=-1e9),
    "fake": dict(sigma_thresh=0.5, surf_fake_sample=True, limited_fake_sample=False),
}
# (option set, candidates mode) pairs: every option set in both modes, and
# the gate's alone
ALL_MODES = [(k, c) for k in OPTION_SETS for c in (False, True)]
GATE_MODES = [("gate", False), ("gate", True)]
# lattices: windows of 128 voxels along z that end mid-word (33, 129, 130),
# Z % 4 != 0 (the kernel's scalar loads) and == 0 (16-byte loads), runs of
# 32 voxel rows along y that end early (40, 130) and x tiles of 4 columns
# that end early (17, 130)
SHAPES = [(2, 2, 2), (16, 16, 16), (33, 33, 33), (16, 33, 130), (130, 3, 16), (17, 40, 129)]


def occupancy_arrays(shape, stype: str = "sdf", seed: int = 0, prune: float = 0.2,
                     dense: bool = False, dtype=np.float64) -> dict:
    """``reg_grids.shell_arrays`` of ``shape`` as a grid of type ``stype``:
    PLANE's 4 surface channels, the UDF types' surface values 1.5 N(0, 1) -
    0.5 under level sets 0.5 and 0.9 (their softplus, >= 0, reaches both),
    UDF_ALPHA's (2, 1) table of alphas, one per level set."""
    if min(shape) == 2:  # a shell 2 vertices wide may hold no whole voxel
        dense, prune = True, 0.0
    a = shell_arrays(shape, seed=seed, prune=prune, dense=dense, channels=3, dtype=dtype)
    rng = np.random.default_rng(seed + 7)
    cap = a["density_data"].shape[0]
    a["surface_type"] = SURFACE_TYPES[stype]
    if stype == "plane":
        a["surface_data"] = (rng.standard_normal((cap, 4)) * 0.3).astype(dtype)
    if stype in ("udf", "udf_alpha", "udf_fake_sample"):
        a["surface_data"] = (rng.standard_normal((cap, 1)) * 1.5 - 0.5).astype(dtype)
        a["level_set_data"] = np.array([0.5, 0.9], dtype)
    if stype == "udf_alpha":
        a["density_data"] = np.array([[0.3], [1.2]], dtype)
    return a


def relink(a: dict, keep: np.ndarray) -> dict:
    """``a`` with only the vertices of ``keep`` linked, renumbered in flat
    order, and rows drawn for them from the old rows (cycled)."""
    links = np.full(keep.shape, -1, np.int32)
    n = int(keep.sum())
    links[keep] = np.arange(n, dtype=np.int32)
    out = dict(a, links=links)
    cap = a["sh_data"].shape[0]
    rows = np.arange(max(n, 1)) % max(cap, 1)
    for k in ("sh_data", "surface_data"):
        out[k] = a[k][rows]
    if a["density_data"].shape[0] == cap:  # not UDF_ALPHA's table
        out["density_data"] = a["density_data"][rows]
    return out


def special_arrays(case: str, stype: str = "sdf", dtype=np.float64) -> dict:
    """Grids of the walk's edge cases:
    ``absent_tile``: (40, 20, 70), links only at x < 6, so every later tile
    of 4 columns has no present vertex (the warp-uniform skip);
    ``extra_only``: (6, 5, 130), links only at z = 128, the vertex after
    the first window, which its last lane loads as its extra vertex (and
    the second window's first lane as its own); every density positive;
    ``full``: (5, 4, 70), every vertex linked, alpha above the gate and
    every corner hull spanning a level set, so every voxel is occupied and
    bit 31 of each full word is set."""
    if case == "absent_tile":
        a = occupancy_arrays((40, 20, 70), stype, seed=11, prune=0.0, dense=True, dtype=dtype)
        keep = np.zeros((40, 20, 70), bool)
        keep[:6] = True
        return relink(a, keep)
    if case == "extra_only":
        a = occupancy_arrays((6, 5, 130), stype, seed=12, prune=0.0, dense=True, dtype=dtype)
        keep = np.zeros((6, 5, 130), bool)
        keep[:, :, 128] = True
        a = relink(a, keep)
        if a["density_data"].shape[0] > 2:
            a["density_data"] = np.abs(a["density_data"]) + 0.75
        return a
    if case == "full":
        a = occupancy_arrays((5, 4, 70), stype, seed=13, prune=0.0, dense=True, dtype=dtype)
        cap = a["sh_data"].shape[0]
        if a["density_data"].shape[0] == cap:
            a["density_data"] = np.full((cap, 1), 2.0, dtype)
        else:
            a["density_data"] = np.full_like(a["density_data"], 2.0)
        # alternate signs along z around the first level set: every hull spans it
        z = np.nonzero(a["links"].reshape(-1) >= 0)[0] % 70
        lv = a["level_set_data"][0]
        a["surface_data"] = a["surface_data"].copy()
        a["surface_data"][:, 0] = np.where(z % 2 == 0, lv - 0.05, lv + 0.05)
        if stype in ("udf", "udf_alpha", "udf_fake_sample"):
            # softplus(x) = lv -/+ 0.05: x = log(exp(v) - 1)
            a["surface_data"][:, 0] = np.log(np.expm1(a["surface_data"][:, 0]))
        return a
    raise ValueError(case)


SPECIAL_CASES = ("absent_tile", "extra_only", "full")


def card_grids(stype: str, device):
    """The card checks' float32 grids of ``stype`` on ``device``: SHAPES,
    130^3 and the edge cases."""
    for i, shape in enumerate(SHAPES + [(130, 130, 130)]):
        yield shape, SparseGrid.from_numpy(
            occupancy_arrays(shape, stype, seed=i, dtype=np.float32), device=device)
    for case in SPECIAL_CASES:
        yield case, SparseGrid.from_numpy(special_arrays(case, stype, np.float32), device=device)


def misaligned(grid: SparseGrid) -> SparseGrid:
    """``grid`` with its links copied to one element past a 16-byte
    boundary (the kernels' scalar loads)."""
    buf = torch.empty(grid.links.numel() + 1, dtype=torch.int32, device=grid.links.device)
    links = buf[1:].view(grid.links.shape)
    links.copy_(grid.links)
    return grid.replace(links=links)


def check_k1_card(stype: str, device) -> int:
    """K1 on the card equal bit for bit to its plain version on the same
    card, on every grid of card_grids and its misaligned copy, each option
    set in both modes; one launch a call. Returns the comparisons made."""
    n = 0
    for label, g in card_grids(stype, device):
        for grid in (g, misaligned(g)):
            for name, candidates in ALL_MODES:
                opt = RenderOptions(**OPTION_SETS[name])
                kernels.reset_launches()
                got = S.occupancy_words(grid, opt, candidates)
                assert kernels.LAUNCHES["occupancy"] == 1, label
                ref = S._occupancy_words_plain(grid, opt, candidates)
                assert torch.equal(got, ref), (stype, label, name, candidates)
                n += 1
    return n


def check_k1d_card(device) -> int:
    """K1d on the card equal bit for bit to its plain version on the CPU,
    on card_grids' SDF grids and their misaligned copies."""
    n = 0
    for label, g in card_grids("sdf", device):
        ref = S.pack_occupancy_bits(C._density_occupancy_plain(
            SparseGrid.from_numpy(g.to_numpy(), device="cpu", dtype=torch.float32)))
        for grid in (g, misaligned(g)):
            kernels.reset_launches()
            got = C.density_occupancy_words(grid)
            assert kernels.LAUNCHES["density_occupancy"] == 1, label
            assert torch.equal(got.cpu(), ref), label
            n += 1
    return n


def check_card(device="cuda") -> None:
    """Every card check of this file, for a machine without JAX or pytest's
    conftest."""
    n = sum(check_k1_card(t, torch.device(device)) for t in SURFACE_TYPES)
    n += check_k1d_card(torch.device(device))
    print(f"occ_grids: {n} comparisons of K1 and K1d with their plain versions, all equal")
