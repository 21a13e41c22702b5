"""K1 and K1d's walk (``alphasurf_torch/csrc/occupancy.cu``) transcribed in
numpy and held to the plain versions and to the JAX package.

The transcription runs every warp of a launch at once: warp (x, window,
run) owns voxel column x, a window of 128 voxels along z and a run of
voxel rows along y (32, halved down to 4 while the launch has fewer than
64 warps an SM of the H100's 132); lane j holds vertices z0 + 4j .. z0 + 4j + 3 of vertex
columns x and x + 1 (16-byte copies where Z % 4 == 0, else 4-byte ones) and
the window's last lane the vertex after the window. Per vertex row: the
ballot's skip of a row with no vertex present in both columns, the gathers
of the present vertices, vertex 4 from the next lane, the z pairs, the
carried row before, the 4 bits of each lane packed into word j / 8 by lane.
Every word is written once. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``, ``app/bench_k2.py``)."""
import jax
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render.cuvol import density_occupancy as j_density_occupancy
from alphasurf_tpu.render.surface import pack_occupancy_bits as j_pack
from alphasurf_tpu.render.surface import voxel_occupancy as j_voxel_occupancy
from alphasurf_torch.core.grid import UDF_TYPES, SparseGrid
from alphasurf_torch.render import cuvol as C
from alphasurf_torch.render import surface as S
from occ_grids import (ALL_MODES, GATE_MODES, OPTION_SETS, SHAPES, SPECIAL_CASES, SURFACE_TYPES,
                       occupancy_arrays, special_arrays)
from test_torch_util import jax_grid

VERTS, LANES, ROWS = 4, 32, 32  # occupancy.cu's kOccVerts, a warp, kOccRows
WINDOW = VERTS * LANES
WARPS_PER_SM, N_SM = 64, 132  # occupancy.cu's kOccWarpsPerSM, the H100's SMs


def run_rows(X: int, Y: int, Z: int, n_sm: int = N_SM) -> int:
    """occ_grid's run length: kOccRows, halved down to 4 while the launch
    has fewer than WARPS_PER_SM warps an SM."""
    cols = (X - 1) * -(-(Z - 1) // WINDOW)
    rows = ROWS
    while rows > 4 and cols * -(-(Y - 1) // rows) < n_sm * WARPS_PER_SM:
        rows //= 2
    return rows


class Walk:
    """The warps of one launch over ``links`` and their loads: ``reads``
    counts each link's loads, ``gathers`` each warp's row gathers."""

    def __init__(self, links: np.ndarray, rows: int | None = None):
        self.links = links
        X, Y, Z = links.shape
        self.n_rows = run_rows(X, Y, Z) if rows is None else rows
        self.W = (Z - 1 + 31) // 32
        n_win, n_run = -(-(Z - 1) // WINDOW), -(-(Y - 1) // self.n_rows)
        x, win, run = np.meshgrid(np.arange(X - 1), np.arange(n_win), np.arange(n_run),
                                  indexing="ij")
        self.x, self.win = x.ravel(), win.ravel()
        self.y0 = run.ravel() * self.n_rows
        self.y1 = np.minimum(self.y0 + self.n_rows, Y - 1)
        self.zl = self.win[:, None] * WINDOW + VERTS * np.arange(LANES)[None, :]
        self.zx = self.win * WINDOW + WINDOW
        self.vec = Z % 4 == 0
        self._loaded = []  # flat indices of every link load
        self.gathers = np.zeros(self.x.shape[0], np.int64)
        self.words = np.zeros((X - 1, Y - 1, self.W), np.int64)
        self.writes = np.zeros(self.words.shape, np.int64)

    def load(self, col, y, act) -> np.ndarray:
        """(warps, lanes, 5) links of vertex row y of columns ``col``, -1
        past Z (load_links): 4 vertices a lane, the 5th the last lane's."""
        X, Y, Z = self.links.shape
        v = np.full(self.zl.shape + (5,), -1, np.int32)
        cols = np.broadcast_to(col[:, None], self.zl.shape)
        rows = np.broadcast_to(y[:, None], self.zl.shape)
        for k in range(VERTS):
            if self.vec:  # one 16-byte load: zl < Z holds all 4 vertices
                ok = act[:, None] & (self.zl < Z)
                assert np.all(self.zl[ok] + VERTS <= Z)
            else:
                ok = act[:, None] & (self.zl + k < Z)
            z = self.zl + k
            v[..., k][ok] = self.links[cols[ok], rows[ok], z[ok]]
            self._loaded.append((cols[ok] * Y + rows[ok]) * Z + z[ok])
        ok = act & (self.zx < Z)
        v[ok, LANES - 1, 4] = self.links[col[ok], y[ok], self.zx[ok]]
        self._loaded.append((col[ok] * Y + y[ok]) * Z + self.zx[ok])
        return v

    @property
    def reads(self) -> np.ndarray:
        """The loads of each link."""
        return np.bincount(np.concatenate(self._loaded),
                           minlength=self.links.size).reshape(self.links.shape)

    def store(self, nib, act, y) -> None:
        """Pack each lane's 4 bits into word j // 8 of the window (8 lanes x
        4 bits) and store the window's words below W at voxel row y - 1."""
        shift = 4 * (np.arange(LANES) % 8)
        words = (nib.astype(np.int64) << shift).reshape(-1, 4, 8).sum(-1)  # (warps, 4)
        for g in range(4):
            w = self.win * 4 + g
            ok = act & (w < self.W)
            self.words[self.x[ok], y[ok] - 1, w[ok]] = words[ok, g]
            self.writes[self.x[ok], y[ok] - 1, w[ok]] += 1

    def result(self) -> np.ndarray:
        """The words as int32, after checking each was written once."""
        assert np.all(self.writes == 1)
        w = self.words
        return np.where(w >= 2**31, w - 2**32, w).astype(np.int32)

    def rows(self):
        """(j, y, act) of the walk's vertex rows: row y0 + j of each warp
        whose run reaches it."""
        Y = self.links.shape[1]
        for j in range(self.n_rows + 1):
            y = self.y0 + j
            act = y <= self.y1
            yield j, np.minimum(y, Y - 1), act


def k1_walk(links, density, dens_stride, surface, n_surf_c, level_sets, sigma_thresh, hull,
            udf, rows=None) -> tuple[np.ndarray, Walk]:
    """K1's words by occupancy_kernel's decomposition (``kernels.occupancy``'s
    arguments; ``surface`` flat, rows n_surf_c apart), in runs of ``rows``
    (occ_grid's choice by default)."""
    walk = Walk(links, rows)
    shape = walk.zl.shape
    inf = np.inf
    dt = surface.dtype
    cp = np.zeros(shape + (4,), bool)
    cd = np.full(shape + (4,), -inf, dt)
    clo, chi = np.full(shape + (4,), inf, dt), np.full(shape + (4,), -inf, dt)

    def values(link):
        d = density[link.astype(np.int64) * dens_stride]
        if not hull:
            return d, np.zeros_like(d)
        s = surface[link.astype(np.int64) * n_surf_c]
        if udf:
            s = S.softplus(torch.as_tensor(s)).numpy()
        return d, s

    for j, y, act in walk.rows():
        a, b = walk.load(walk.x, y, act), walk.load(walk.x + 1, y, act)
        pv = (a >= 0) & (b >= 0)
        go = act & pv.any(axis=(1, 2))  # the ballot: no vertex present in both columns
        d = np.full(shape + (5,), -inf, dt)
        lo, hi = np.full(shape + (5,), inf, dt), np.full(shape + (5,), -inf, dt)
        m = pv & go[:, None, None]
        da, sa = values(a[m])
        db, sb = values(b[m])
        d[m], lo[m], hi[m] = np.maximum(da, db), np.minimum(sa, sb), np.maximum(sa, sb)
        walk.gathers += 2 * m.sum(axis=(1, 2))
        # vertex 4 is the next lane's vertex 0 (the last lane keeps its extra)
        pv = pv & go[:, None, None]
        for v in (pv, d, lo, hi):
            v[:, :-1, 4] = v[:, 1:, 0]
        pz = pv[..., :4] & pv[..., 1:]
        dz = np.maximum(d[..., :4], d[..., 1:])
        loz, hiz = np.minimum(lo[..., :4], lo[..., 1:]), np.maximum(hi[..., :4], hi[..., 1:])
        if j > 0:  # voxel row y - 1: the carried row and this one
            both = cp & pz
            smin, smax = np.minimum(clo, loz), np.maximum(chi, hiz)
            ok = both & (np.maximum(cd, dz) >= sigma_thresh)
            if hull:
                has = np.zeros_like(ok)
                for lv in level_sets:
                    has |= (lv >= smin) & (lv <= smax)
                ok &= has
            nib = (ok.astype(np.int64) << np.arange(4)).sum(-1)
            walk.store(nib, act, y)
        live = act[:, None, None]
        cp = np.where(live, pz, cp)
        cd, clo, chi = (np.where(live, new, old) for new, old in
                        ((dz, cd), (loz, clo), (hiz, chi)))
    return walk.result(), walk


def k1d_walk(links, density, rows=None) -> tuple[np.ndarray, Walk]:
    """K1d's words by density_occupancy_kernel's decomposition."""
    walk = Walk(links, rows)
    Z = links.shape[2]
    inside = (1 << np.clip(Z - 1 - walk.zl, 0, VERTS)) - 1  # the lane's voxels below Z - 1
    cq = np.zeros(walk.zl.shape, np.int64)

    def dense(link):
        out = np.zeros(link.shape, bool)
        on = link >= 0
        out[on] = density[link[on]] > 0
        walk.gathers += on.sum(axis=(1, 2))
        return out

    for j, y, act in walk.rows():
        a, b = walk.load(walk.x, y, act), walk.load(walk.x + 1, y, act)
        q = dense(a) | dense(b)
        q[:, :-1, 4] = q[:, 1:, 0]
        qb = (q.astype(np.int64) << np.arange(5)).sum(-1)
        qz = (qb | qb >> 1) & inside
        if j > 0:
            walk.store(cq | qz, act, y)
        cq = np.where(act[:, None], qz, cq)
    return walk.result(), walk


def k1_args(grid: SparseGrid, opt: pt.RenderOptions, candidates: bool) -> tuple:
    """occupancy_words' and kernels.occupancy's arguments of ``grid``, in numpy."""
    sigma_thresh, hull = S._candidate_test(grid, opt, candidates)
    surf = grid.surface_data.numpy()
    if grid.surface_type == pt.defs.SURFACE_TYPE_UDF_ALPHA:
        density = np.asarray([grid.density_data.numpy().max()], surf.dtype)
    else:
        density = grid.density_data.numpy()[:, 0]
    dens_stride = 0 if density.shape[0] == 1 and grid.capacity > 1 else 1
    return (grid.links.numpy(), density, dens_stride, surf.reshape(-1), surf.shape[1],
            grid.level_set_data.numpy(), sigma_thresh, hull, grid.surface_type in UDF_TYPES)


def check_k1(a: dict, modes=ALL_MODES, long_runs: bool = True) -> list:
    """K1's walk equal to the plain version under each (option set,
    candidates) pair of ``modes`` in occ_grid's runs and, with
    ``long_runs``, the gate's in runs of 32 rows too; returns the walks."""
    g = SparseGrid.from_numpy(a, device="cpu")
    walks = []
    for name, candidates, rows in [(*m, None) for m in modes] + long_runs * [("gate", False, 32)]:
        kw = OPTION_SETS[name]
        opt = pt.RenderOptions(**kw)
        got, walk = k1_walk(*k1_args(g, opt, candidates), rows=rows)
        ref = S._occupancy_words_plain(g, opt, candidates).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"{kw} candidates={candidates}")
        walks.append(walk)
    return walks


def check_k1d(a: dict, rows=None) -> Walk:
    g = SparseGrid.from_numpy(a, device="cpu")
    dens = g.density_data.numpy()[:, 0]
    dens = dens[np.minimum(np.arange(g.capacity), dens.shape[0] - 1)]  # density_occupancy_words'
    got, walk = k1d_walk(g.links.numpy(), dens, rows)
    np.testing.assert_array_equal(got, S.pack_occupancy_bits(C._density_occupancy_plain(g)).numpy())
    return walk


def test_run_length_at_the_recipe_shapes():
    """occ_grid's runs: 32 rows at 512^3 (32,704 warps), 8 at 256^3, 4 at
    128^3 and below."""
    assert [run_rows(r, r, r) for r in (512, 256, 128, 16)] == [32, 8, 4, 4]


@pytest.mark.parametrize("stype", list(SURFACE_TYPES))
def test_k1_walk_equals_plain_version(stype):
    """Every option set and mode: SDF at each lattice of occ_grids.SHAPES,
    the other types at 16^3 and (17, 40, 129); in float64 and (at 16^3)
    float32."""
    shapes = SHAPES if stype == "sdf" else [(16, 16, 16), (17, 40, 129)]
    for i, shape in enumerate(shapes):
        walks = check_k1(occupancy_arrays(shape, stype, seed=i))
        assert any(w.words.any() for w in walks), shape
    check_k1(occupancy_arrays((16, 16, 16), stype, seed=9, dtype=np.float32), GATE_MODES,
             long_runs=False)


def test_walk_at_130_cubed_reads_each_link_about_twice():
    """K1 (SDF) and K1d at 130^3: two windows, the second of 1 word, runs
    and x tiles that end early, scalar loads. In runs of 32 rows (512^3's)
    each link is loaded by the two column pairs it belongs to, once more at
    a run's first row or a window's extra vertex: at least once, at most 8
    times, ~2 times on average; K1d also in occ_grid's runs of 4."""
    a = occupancy_arrays((130, 130, 130), "sdf", seed=3)
    g = SparseGrid.from_numpy(a, device="cpu")
    opt = pt.RenderOptions(**OPTION_SETS["gate"])
    got, walk = k1_walk(*k1_args(g, opt, False), rows=32)
    np.testing.assert_array_equal(got, S._occupancy_words_plain(g, opt).numpy())
    reads = walk.reads
    assert reads.min() >= 1 and reads.max() <= 8 and reads.mean() < 2.1
    check_k1d(a, rows=32)
    check_k1d(a)


@pytest.mark.parametrize("case", SPECIAL_CASES)
def test_k1_walk_edge_cases(case):
    """An all-absent tile (no gathers: the ballot's skip), a window whose
    only present vertex is its last lane's extra one, and every voxel
    occupied (bit 31, the int32 sign), for every type."""
    for stype in SURFACE_TYPES:
        walks = check_k1(special_arrays(case, stype), GATE_MODES, long_runs=False)
        if case == "absent_tile":
            for w in walks:
                assert not w.gathers[w.x >= 5].any()  # pairs of columns x, x + 1 >= 6
                assert w.gathers[w.x < 5].all()
        if case == "extra_only":
            assert all(not w.words.any() for w in walks)
            assert walks[0].gathers[walks[0].win == 0].any()  # the extra vertex is read
        if case == "full":
            w = walks[0].result()
            assert (w[..., :2] == -1).all() and ((w[..., 2].view(np.uint32)) == 2**5 - 1).all()


@pytest.mark.parametrize("case", ("shapes",) + SPECIAL_CASES)
def test_k1d_walk_equals_plain_version(case):
    """K1d at each lattice and edge case: the extra vertex, the z OR (a
    voxel past Z - 1 stays empty), the empty tile."""
    if case == "shapes":
        for i, shape in enumerate(SHAPES):
            check_k1d(occupancy_arrays(shape, "sdf", seed=20 + i))
        check_k1d(occupancy_arrays((16, 16, 16), "sdf", seed=9, dtype=np.float32))
        return
    walk = check_k1d(special_arrays(case))
    if case == "extra_only":  # voxels 127 (the extra vertex) and 128 of every column pair
        w = walk.result()
        assert (w[..., 3] == np.int32(-2**31)).all() and (w[..., 4] == 1).all()
        assert not w[..., :3].any()
    if case == "absent_tile":
        assert not walk.gathers[walk.x >= 6].any()


@pytest.mark.parametrize("stype", ["sdf", "udf", "plane"])
def test_k1_walk_equals_jax(stype):
    """The walk against JAX's voxel_occupancy + pack_occupancy_bits at 16^3
    (jitted) under each option set; K1d's against density_occupancy."""
    a = occupancy_arrays((16, 16, 16), stype, seed=5)
    g, gj = SparseGrid.from_numpy(a, device="cpu"), jax_grid(a)
    for kw in OPTION_SETS.values():
        fn = jax.jit(lambda grid, kw=kw: j_pack(j_voxel_occupancy(grid, at.RenderOptions(**kw))))
        ref = np.asarray(fn(gj)).view(np.int32)
        got, _ = k1_walk(*k1_args(g, pt.RenderOptions(**kw), False))
        np.testing.assert_array_equal(got, ref, err_msg=str(kw))
    if stype == "sdf":
        rows = g.density_data.numpy()[:, 0]
        got, _ = k1d_walk(g.links.numpy(), rows)
        ref = np.asarray(jax.jit(lambda grid: j_pack(j_density_occupancy(grid)))(gj))
        np.testing.assert_array_equal(got, ref.view(np.int32))
