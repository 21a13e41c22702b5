"""K2: the port's exact pool of occupied crossings against the JAX
package's pool (restricted to its valid entries), for JAX's flat
enumeration and its supervoxel path, and on the corner-crossing camera."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render.surface import _prep as j_prep
from alphasurf_tpu.render.surface import compact_crossings_packed as j_compact
from alphasurf_tpu.render.surface import voxel_occupancy as j_occ
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render.surface import _compact_crossings_plain
from alphasurf_torch.render.surface import _prep as t_prep
from alphasurf_torch.render.surface import compact_crossings_packed as t_compact
from alphasurf_torch.render.surface import occupancy_words
from test_torch_util import corner_camera_rays, jax_grid, lattice_rays, np_grid, np_rays, t64

OPT = dict(sigma_thresh=-1e9, only_outward_intersect=True)


def _sorted(ray, l, ct, ft):
    """Order by (ray, t, l): JAX's lax.sort is not stable on t ties."""
    key = np.lexsort((l[:, 2], l[:, 1], l[:, 0], ct, ray))
    return ray[key], l[key], ct[key], ft[key]


def _pools(a, o, d, coarse_factor):
    gj, gt = jax_grid(a), SparseGrid.from_numpy(a, device="cpu")
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    origins, dirs, _, tnear, tmax, _, ray_ok, _ = j_prep(gj, at.Rays(oj, dj), at.RenderOptions(**OPT))
    tn, tx = jnp.where(ray_ok, tnear, 0.0), jnp.where(ray_ok, tmax, -1.0)
    M = 64 * o.shape[0]
    ray_id, l, ct, ft, valid, n_occ, drop = j_compact(
        gj, origins, dirs, tn, tx, j_occ(gj, at.RenderOptions(**OPT)), M,
        coarse_factor=coarse_factor, supers_per_ray=32.0)
    assert int(drop) == 0
    v = np.asarray(valid)
    jp = (np.asarray(ray_id)[v], np.asarray(l)[v], np.asarray(ct)[v], np.asarray(ft)[v])

    to, td, _, ttn, ttx, _, tok, _ = t_prep(gt, pt.Rays(t64(o), t64(d)), pt.RenderOptions(**OPT))
    pool = t_compact(gt, to, td, torch.where(tok, ttn, torch.zeros_like(ttn)),
                     torch.where(tok, ttx, torch.full_like(ttx, -1.0)),
                     occupancy_words(gt, pt.RenderOptions(**OPT)))
    return jp, np.asarray(n_occ), pool


def _check(jp, n_occ_j, pool):
    tp = (pool.ray_id.numpy(), pool.l.numpy(), pool.close_t.numpy(), pool.far_t.numpy())
    # the port's pool is ray-major and t-ascending as it stands
    assert np.all(np.diff(tp[0]) >= 0)
    same_ray = np.diff(tp[0]) == 0
    assert np.all(np.diff(tp[2])[same_ray] >= 0)
    np.testing.assert_array_equal(
        pool.offsets.numpy(), np.r_[0, np.cumsum(np.bincount(tp[0], minlength=len(n_occ_j)))])
    js, ts = _sorted(*jp), _sorted(*tp)
    assert len(ts[0]) == len(js[0]) > 0
    np.testing.assert_array_equal(ts[0], js[0])
    np.testing.assert_array_equal(ts[1], js[1])
    np.testing.assert_allclose(ts[2], js[2], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ts[3], js[3], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(pool.n_occupied.numpy(), n_occ_j)


@pytest.mark.parametrize("coarse_factor", [0, 8])
def test_pool_matches_jax(coarse_factor):
    a = np_grid(16, seed=7, prune=0.1)
    o, d = np_rays(64, seed=8)
    _check(*_pools(a, o, d, coarse_factor))


@pytest.mark.parametrize("coarse_factor", [0, 8])
def test_pool_matches_jax_on_corner_crossings(coarse_factor):
    from alphasurf_tpu.data.synthetic import make_gt_grid
    from test_torch_util import jax_to_np

    a = jax_to_np(make_gt_grid(16))
    a = {k: (np.asarray(v, np.float64) if k not in ("links", "basis_dim", "surface_type")
             and v is not None else v) for k, v in a.items()}
    o, d = corner_camera_rays(8)
    _check(*_pools(a, o, d, coarse_factor))


# --- K2's order contract -------------------------------------------------
#
# The kernel walks each ray's candidates in merged t order: the tnear entry
# first, then the three axes' plane sequences, the least t first, the lower
# axis at equal t; occupied candidates whose slab is a sliver are dropped.
# Below is that serial walk transcribed literally in numpy float32 (the
# kernel's arithmetic, op for op, without FMAs): its pool must equal the
# plain version's element for element in order, and its n_occupied too.
# Every windowed or group-parallel design of the kernel has to give this
# pool. (At an exact tie the lower axis's candidate is always a sliver: its
# voxel's slab ends at the other axis's plane, at the same t.)

_F = np.float32
_SNAP, _EPS = _F(1e-5), _F(1e-9)


def _safe(d):
    return _F(1e-12) if d == 0 else d


def _snap(o, d, pb, crossed_if_le, t_ref, tie):
    fl, q = np.floor(pb), np.rint(pb)
    if not (abs(pb - q) < _SNAP and d != 0):
        return int(fl)
    tq = (q - o) / _safe(d)
    crossed = tq <= t_ref if crossed_if_le else (tq < t_ref or (tie and tq == t_ref))
    cr = _F(1) if crossed else _F(0)
    return int(q - _F(1) + cr) if d > 0 else int(q - cr)


def _plane_t(k, o, d):
    return (_F(k) - o) / d


def _serial_walk(reso, o, d, tn, tx, words):
    """One ray's entries [(l, close_t, far_t)], its occupied-candidate count
    and the number of exact ties between axis heads on its walk."""
    lo, hi = tn + _EPS, tx - _EPS
    entries, n_occ = [], 0

    def visit(t, l):
        nonlocal n_occ
        if any(l[a] < 0 or l[a] > reso[a] - 2 for a in range(3)):
            return
        if not (int(words[l[0], l[1], l[2] >> 5]) >> (l[2] & 31)) & 1:
            return
        n_occ += 1
        far = _F(np.inf)
        for a in range(3):
            f = (_F(l[a]) + (_F(0) if d[a] < 0 else _F(1)) - o[a]) / _safe(d[a])
            far = min(far, f if np.isfinite(f) else _F(np.inf))
        far = min(far, tx)
        if far > t + _EPS:
            entries.append((l, t, far))

    if tx > lo:
        visit(tn, [_snap(o[b], d[b], o[b] + tn * d[b], True, tn + _EPS, False) for b in range(3)])
    q, step, tq, live = [0] * 3, [0] * 3, [_F(0)] * 3, [False] * 3
    for a in range(3):
        pmax = reso[a] - 2
        if d[a] == 0 or pmax < 1:
            continue
        pos0 = o[a] + tn * d[a]
        k = int(min(max(np.floor(pos0) if d[a] > 0 else np.ceil(pos0), _F(1)), _F(pmax)))
        if d[a] > 0:
            step[a] = 1
            while k > 1 and _plane_t(k - 1, o[a], d[a]) > lo:
                k -= 1
            while k <= pmax and not _plane_t(k, o[a], d[a]) > lo:
                k += 1
            if k > pmax:
                continue
        else:
            step[a] = -1
            while k < pmax and _plane_t(k + 1, o[a], d[a]) > lo:
                k += 1
            while k >= 1 and not _plane_t(k, o[a], d[a]) > lo:
                k -= 1
            if k < 1:
                continue
        t = _plane_t(k, o[a], d[a])
        if t < hi:
            q[a], tq[a], live[a] = k, t, True
    ties = 0
    while True:
        a = -1
        for k in range(3):
            if live[k] and (a < 0 or tq[k] < tq[a]):
                a = k
        if a < 0:
            break
        t = tq[a]
        ties += sum(live[b] and tq[b] == t for b in range(3) if b != a)
        visit(t, [q[a] - (1 if d[a] < 0 else 0) if b == a else
                  _snap(o[b], d[b], o[b] + t * d[b], False, t, b < a) for b in range(3)])
        k = q[a] + step[a]
        if k < 1 or k > reso[a] - 2 or not _plane_t(k, o[a], d[a]) < hi:
            live[a] = False
            continue
        q[a], tq[a] = k, _plane_t(k, o[a], d[a])
    return entries, n_occ, ties


def _float32(a):
    return {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
                else v) for k, v in a.items()}


def _order_case(case):
    """(grid, float32 grid-space origins, dirs, tn, tx) of a test case."""
    if case == "corner":
        from alphasurf_tpu.data.synthetic import make_gt_grid
        from test_torch_util import jax_to_np

        a, (o, d) = jax_to_np(make_gt_grid(16)), corner_camera_rays(8)
    else:
        a, (o, d) = np_grid(16, seed=7, prune=0.1), np_rays(64, seed=8)
    gt = SparseGrid.from_numpy(_float32(a), device="cpu")
    if case == "lattice":
        return gt, *(torch.as_tensor(x) for x in lattice_rays(64, 16, seed=9))
    to, td, _, tnear, tmax, _, ok, _ = t_prep(
        gt, pt.Rays(torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)),
        pt.RenderOptions(**OPT))
    return (gt, to, td, torch.where(ok, tnear, torch.zeros_like(tnear)),
            torch.where(ok, tmax, torch.full_like(tmax, -1.0)))


@pytest.mark.parametrize("case", ["random", "corner", "lattice"])
def test_serial_walk_order_equals_plain_pool(case):
    gt, o, d, tn, tx = _order_case(case)
    assert o.dtype == torch.float32
    words = occupancy_words(gt, pt.RenderOptions(**OPT))
    ref = _compact_crossings_plain(gt.reso, o, d, tn, tx, words)
    w = words.numpy()
    rows, ls, cts, fts, n_occ, ties = [], [], [], [], [], 0
    with np.errstate(over="ignore", divide="ignore"):
        for r in range(o.shape[0]):
            ent, n, t = _serial_walk(gt.reso, o[r].numpy(), d[r].numpy(), tn[r].numpy()[()],
                                     tx[r].numpy()[()], w)
            rows += [r] * len(ent)
            ls += [e[0] for e in ent]
            cts += [e[1] for e in ent]
            fts += [e[2] for e in ent]
            n_occ.append(n)
            ties += t
    assert len(rows) > 0
    if case == "lattice":
        assert ties > 0  # the case exercises the tie rule
    np.testing.assert_array_equal(ref.ray_id.numpy(), np.asarray(rows, np.int32))
    np.testing.assert_array_equal(ref.l.numpy(), np.asarray(ls, np.int32).reshape(-1, 3))
    np.testing.assert_array_equal(ref.close_t.numpy(), np.asarray(cts, np.float32))
    np.testing.assert_array_equal(ref.far_t.numpy(), np.asarray(fts, np.float32))
    np.testing.assert_array_equal(ref.n_occupied.numpy(), np.asarray(n_occ, np.int32))
