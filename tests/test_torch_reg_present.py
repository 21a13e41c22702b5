"""K6's work lists on the card, transcribed in numpy float64 and held to the
JAX package's losses: the every-cell TV and normal visit the present rows
of the row coordinates (a row counts where the link at its coordinates
names it), the normal only base vertices inside the interior box, the TV
adds the empty cells' sqrt(1e-5) floor for every cell and each present
row takes it back; the TV of many channels runs a warp a cell, lane c on
channel c0 + c in chunks of 32, and adds each row's gradient in float4
slots. The transcriptions follow ``csrc/reg.cu`` (``tv_row``,
``normal_row``, ``normal_at``, ``tv_cell_wide``, ``add_row_slots``) line for
line, in float64, with their analytic gradients and, for the warp a cell,
the lanes' sums; the references are
``jax.value_and_grad`` of ``surface_tv_loss_dense``,
``surface_normal_loss_dense`` and ``tv_loss``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphasurf_tpu.losses import reg as J
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as T
from reg_grids import row_coords, shell_arrays
from test_torch_util import jax_grid

# float64 on both sides: the transcription's analytic gradient and the
# autodiff one differ by rounding carried through a few dozen operations,
# and the loss by the order of its sum over cells
LOSS_RTOL, GRAD_RTOL = 1e-12, 1e-10


def _link(links, x, y, z):
    X, Y, Z = links.shape
    ok = (x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0) & (z < Z)
    return np.where(ok, links[np.clip(x, 0, X - 1), np.clip(y, 0, Y - 1), np.clip(z, 0, Z - 1)],
                    -1)


def present_rows(links, rc):
    """The rows whose coordinates' link names them (row_cell)."""
    n = rc.shape[0]
    return np.nonzero(links[rc[:, 0], rc[:, 1], rc[:, 2]] == np.arange(n))[0]


def tv_every(a, rc, weighted):
    """tv_row over every row, plus the wrapper's links.size k_empty: the
    loss over links.size cells and its gradient in the surface rows."""
    links, s = a["links"], a["surface_data"][:, 0]
    N, cap = links.size, len(rc)
    k_empty = np.sqrt(1e-5) * (0.5 if weighted else 1.0)
    has = np.zeros(cap, bool)
    has[present_rows(links, rc)] = True
    x, y, z = np.where(has[:, None], rc, -8).astype(np.int64).T  # no row: no links
    nb = [_link(links, x + 1, y, z), _link(links, x, y + 1, z), _link(links, x, y, z + 1)]
    d = [np.where(has & (ln >= 0), s[np.maximum(ln, 0)] - s, 0.0) for ln in nb]
    sq = np.sqrt(1e-5 + d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    aw = 1.0 / (1.0 + np.exp(-a["density_data"][:, 0])) if weighted else np.ones(cap)
    loss = N * k_empty + np.sum(np.where(has, sq * aw - k_empty, 0.0))
    g = np.where(has, aw / sq, 0.0)
    grad = np.zeros_like(s)
    for ln, dk in zip(nb, d):
        on = has & (ln >= 0)
        np.add.at(grad, ln[on], (g * dk)[on])
    np.add.at(grad, np.nonzero(has)[0], -(g * d[0] + g * d[1] + g * d[2])[has])
    return loss / N, grad[:, None] / N


def _unit(v):
    sq = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    q = np.sqrt(np.where(sq > 1e-20, sq, 1e-20))
    m = np.maximum(q, 1e-10)
    return v / m[:, None], (v, sq, q, m)


def _unit_vjp(u, gN):
    v, sq, q, m = u
    vg = np.sum(v * gN, -1)
    through = (sq > 1e-20) * np.where(q > 1e-10, 1.0, np.where(q == 1e-10, 0.5, 0.0))
    c = through * vg / (q * m * m)
    return gN / m[:, None] - v * c[:, None]


def normal_every(a, rc, con_check, ignore_empty, use_l1):
    """normal_row over every row: the present base vertices in the interior
    box, each cell stopping where its base cube misses a corner."""
    links, s, lv = a["links"], a["surface_data"][:, 0], a["level_set_data"]
    X, Y, Z = links.shape
    cap = len(rc)
    has = np.zeros(cap, bool)
    has[present_rows(links, rc)] = True
    x, y, z = np.where(has[:, None], rc, -8).astype(np.int64).T
    box = has & (x <= X - 3) & (y <= Y - 3) & (z <= Z - 3)
    o = np.arange(3)
    L = _link(links, x[:, None, None, None] + o[:, None, None], y[:, None, None, None]
              + o[None, :, None], z[:, None, None, None] + o[None, None, :])  # (cap, 3, 3, 3)
    n = cap
    S = np.where(L >= 0, s[np.maximum(L, 0)], 0.0)
    live_cell = box & (L[:, :2, :2, :2].reshape(n, -1) >= 0).all(-1)

    def cube(b):
        return S[:, b[0]:b[0] + 2, b[1]:b[1] + 2, b[2]:b[2] + 2].reshape(n, 8)  # z fastest

    def cell_normal(b):
        c = cube(b)
        return np.stack([(c[:, 4:].sum(-1) - c[:, :4].sum(-1)) / 4.0,
                         (c[:, [2, 3, 6, 7]].sum(-1) - c[:, [0, 1, 4, 5]].sum(-1)) / 4.0,
                         (c[:, 1::2].sum(-1) - c[:, ::2].sum(-1)) / 4.0], -1)

    def exists(b):
        return (L[:, b[0]:b[0] + 2, b[1]:b[1] + 2, b[2]:b[2] + 2].reshape(n, 8) >= 0).all(-1)

    def face_con(vals):
        v = np.stack(vals, -1)
        mn, mx = v.min(-1, keepdims=True), v.max(-1, keepdims=True)
        return ((lv >= mn) & (lv <= mx)).any(-1)

    def empty(b):
        c = cube(b)
        return (c <= 0).all(-1) | (c >= 0).all(-1)

    B = {"000": (0, 0, 0), "001": (0, 0, 1), "010": (0, 1, 0), "100": (1, 0, 0)}
    N, U = {}, {}
    for k, b in B.items():
        N[k], U[k] = _unit(cell_normal(b))
    ones, zeros = np.ones(n, bool), np.zeros(n, bool)
    con = {"001": face_con([S[:, 0, 0, 1], S[:, 0, 1, 1], S[:, 1, 0, 1], S[:, 1, 1, 1]]),
           "010": face_con([S[:, 0, 1, 0], S[:, 0, 1, 1], S[:, 1, 1, 0], S[:, 1, 1, 1]]),
           "100": face_con([S[:, 1, 0, 0], S[:, 1, 0, 1], S[:, 1, 1, 0], S[:, 1, 1, 1]])} \
        if con_check else dict.fromkeys(("001", "010", "100"), ones)
    emp = {k: empty(b) for k, b in B.items()} if ignore_empty else dict.fromkeys(B, zeros)
    skip = {k: ~exists(B[k]) | ~con[k] | (emp["000"] & emp[k]) for k in ("001", "010", "100")}
    count = 3 - sum(skip[k].astype(np.int64) for k in skip)
    live = (count > 0) & live_cell
    cnt = np.where(live, count, 1).astype(np.float64)
    total = np.zeros(n)
    gn = {k: np.zeros((n, 3)) for k in B}
    for k in ("001", "010", "100"):
        e = N[k] - N["000"]
        acc = np.abs(e).sum(-1) if use_l1 else (e * e).sum(-1)
        ge = np.sign(e) if use_l1 else 2.0 * e
        on = (~skip[k] & live)[:, None]
        total += np.where(skip[k], 0.0, acc)
        gn[k] = np.where(on, ge / cnt[:, None], 0.0)
        gn["000"] -= gn[k]
    loss = np.sum(np.where(live, total / cnt, 0.0))
    G = np.zeros((n, 3, 3, 3))
    for k, b in B.items():
        gv = _unit_vjp(U[k], gn[k])
        for i in (0, 1):
            for j in (0, 1):
                for kk in (0, 1):
                    sgn = np.array([i, j, kk]) * 0.5 - 0.25
                    G[:, b[0] + i, b[1] + j, b[2] + kk] += gv @ sgn
    grad = np.zeros_like(s)
    on = box[:, None, None, None] & (L >= 0) & (G != 0)
    np.add.at(grad, L[on], G[on])
    Nc = links.size
    return loss / Nc, grad[:, None] / Nc


def add_row_slots(grad_flat, e0, m, v):
    """add_row_slots: lane j's value v[j] of element e0 + j, j < m <= 32, in
    the float4 slots those elements lie in (slot lane q takes elements
    e0 - ph + 4q .. + 3; one outside the m adds 0)."""
    ph = e0 & 3
    for q in range((ph + m + 3) >> 2):
        for t in range(4):
            j = 4 * q + t - ph
            grad_flat[e0 - ph + 4 * q + t] += v[j] if 0 <= j < m else 0.0


def tv_window_wide(a, field, cells, c0, c1):
    """tv_cell_wide over a window: the loss summed over lanes and cells, the
    gradient through the float4 slots; over the window's size."""
    links, data = a["links"], a[field]
    X, Y, Z = links.shape
    rows, C = data.shape
    grad = np.zeros(rows * C + 4)  # the slot past the end adds element by element
    loss = 0.0
    for c in cells:
        x, y, z = c // (Y * Z), (c // Z) % Y, c % Z
        l0 = int(_link(links, x, y, z))
        nb = [int(_link(links, x + 1, y, z)), int(_link(links, x, y + 1, z)),
              int(_link(links, x, y, z + 1))]
        for cb in range(c0, c1, 32):
            m = min(32, c1 - cb)
            lane = np.arange(32)
            on = lane < m
            ch = np.minimum(cb + lane, C - 1)
            v0 = data[l0, ch] if l0 >= 0 else np.zeros(32)
            d = [data[ln, ch] - v0 if l0 >= 0 and ln >= 0 else np.zeros(32) for ln in nb]
            sq = np.sqrt(1e-5 + d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            loss += np.sum(np.where(on, sq, 0.0))
            g = 1.0 / sq
            for ln, dk in zip(nb, d):
                if l0 >= 0 and ln >= 0:
                    add_row_slots(grad, ln * C + cb, m, g * dk)
            if l0 >= 0 and max(nb) >= 0:
                add_row_slots(grad, l0 * C + cb, m, -(g * d[0] + g * d[1] + g * d[2]))
    assert not grad[rows * C:].any()
    return loss / len(cells), grad[:rows * C].reshape(rows, C) / len(cells)


CASES = {
    "cubic": (dict(reso=(12, 12, 12)), False, False, False),
    "non_cubic": (dict(reso=(12, 9, 14)), False, False, False),
    "alpha_weighted": (dict(reso=(11, 13, 10)), True, False, False),
    "con_check_ignore_empty": (dict(reso=(12, 12, 12)), False, True, True),
    "orphans": (dict(reso=(12, 9, 14), orphans=9, unlink=7, link000=True), True, True, False),
    "orphans_all_present": (dict(reso=(9, 10, 8), dense=True, prune=0.1, orphans=4, unlink=6,
                                 link000=True), False, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_present_vertex_work_list_matches_jax_dense_losses(case):
    kw, weighted, con_check, ignore_empty = CASES[case]
    a = shell_arrays(seed=5, prune=kw.pop("prune", 0.2), **kw)
    cap = a["surface_data"].shape[0]
    rc = row_coords(a["links"], cap)
    gt = SparseGrid.from_numpy(a, device="cpu")
    np.testing.assert_array_equal(T.row_coords_of(gt).numpy(), rc)
    if case.startswith("orphans"):
        assert len(present_rows(a["links"], rc)) < cap
    # JAX's dense field scatters every row at its coordinates, so a row no
    # link names would land on vertex (0, 0, 0): the reference gets those
    # rows' coordinates outside the lattice, where its scatter drops them
    rc_j = rc.copy()
    rc_j[np.setdiff1d(np.arange(cap), present_rows(a["links"], rc)), 0] = a["links"].shape[0]
    gj = jax_grid(a)
    refs = [(lambda s, d: J.surface_tv_loss_dense(gj.replace(surface_data=s, density_data=d),
                                                  jnp.asarray(rc_j), weighted),
             tv_every(a, rc, weighted),
             lambda g: T.surface_tv_loss_dense(g, T.row_coords_of(g), weighted))]
    for use_l1 in (True, False):
        refs.append((lambda s, d, use_l1=use_l1: J.surface_normal_loss_dense(
                        gj.replace(surface_data=s, density_data=d), jnp.asarray(rc_j),
                        con_check, ignore_empty, use_l1),
                     normal_every(a, rc, con_check, ignore_empty, use_l1),
                     lambda g, use_l1=use_l1: T.surface_normal_loss_dense(
                         g, T.row_coords_of(g), con_check, ignore_empty, use_l1)))
    for j_fn, (loss, grad), t_fn in refs:
        ref_v, ref_g = jax.value_and_grad(j_fn)(jnp.asarray(a["surface_data"]),
                                                jnp.asarray(a["density_data"]))
        np.testing.assert_allclose(loss, float(ref_v), rtol=LOSS_RTOL)
        ref_g = np.asarray(ref_g)
        assert np.abs(ref_g).max() > 0
        np.testing.assert_allclose(grad, ref_g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref_g).max())
        # the port's plain version (every cell) is the same function
        gt.surface_data.requires_grad_(True)
        v = t_fn(gt)
        (g_t,) = torch.autograd.grad(v, [gt.surface_data])
        gt.surface_data.requires_grad_(False)
        np.testing.assert_allclose(float(v.detach()), loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g_t.numpy(), grad, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref_g).max())


@pytest.mark.parametrize("channels,c0,c1", [(27, 0, 27), (27, 2, 24), (40, 0, 40), (40, 5, 39),
                                            (6, 1, 5)])
def test_wide_tv_lanes_and_slots_match_jax(channels, c0, c1):
    a = shell_arrays((10, 11, 12), seed=2, prune=0.2, orphans=3, unlink=2, channels=channels)
    gj = jax_grid(a)
    cap = a["sh_data"].shape[0]
    rc = row_coords(a["links"], cap)
    starts = {"present": rc[5:5 + cap // 3], "lattice": None}
    X, Y, Z = a["links"].shape
    for name, c in starts.items():
        cells = (np.arange(37, 37 + a["links"].size // 3) if c is None
                 else (c[:, 0] * Y + c[:, 1]) * Z + c[:, 2]).astype(np.int32)
        loss, grad = tv_window_wide(a, "sh_data", cells, c0, c1)
        ref_v, ref_g = jax.value_and_grad(
            lambda sh: J.tv_loss(gj, sh, jnp.asarray(cells), c0, c1))(
                jnp.asarray(a["sh_data"]))
        np.testing.assert_allclose(loss, float(ref_v), rtol=LOSS_RTOL, err_msg=name)
        ref_g = np.asarray(ref_g)
        np.testing.assert_allclose(grad, ref_g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref_g).max(), err_msg=name)
