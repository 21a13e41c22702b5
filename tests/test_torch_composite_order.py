"""K4's decomposition on the CPU: a float64 numpy transcription of the
compositor kernel's arithmetic (csrc/composite.cu), a ray as groups of G
lanes on consecutive pool entries, held against the port's plain compositor
and, under the dense walk's rules on its pool, the JAX package's dense
renderer (whose first call compiles in ~7 s on the CPU, the packed
renderer's in ~30).

The transcription follows the kernel group by group: per-entry local sums;
the exclusive scans carried from group to group (the truncation index, the
log transmittance at each entry, the cache positions, l_dist's prefixes);
the stop_thresh kill as the group's first dead lane (every later entry dead);
l_dist(_a) as each entry's own sum plus its cross term with the entries
before, with t measured from the ray's first contributing sample; the count
window from the kill; the median's second sweep; the cache's median. G = 4,
so the test rays (up to 13 entries) span up to four groups.

Tolerances: the transcription takes its sums in the kernel's tree order and
the plain version in serial or cumsum order, all in float64, so values agree
to rounding, rtol 1e-9 / atol 1e-10 (observed ~1e-15 relative); counts,
flags, cache rows and picks (the same sample's t) agree exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render import surface as JS
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import surface as S
from test_torch_util import BASE, dense_grid, jax_grid, np_grid, np_rays, t64

G = 4  # lanes a ray in the transcription
RTOL, ATOL = 1e-9, 1e-10


def scan(x):
    """Inclusive prefix over the lanes in the kernel's order (Hillis-Steele)."""
    v = np.array(x, dtype=np.asarray(x).dtype)
    d = 1
    while d < len(v):
        v = np.concatenate([v[:d], v[d:] + v[:-d]])
        d *= 2
    return v


def exclusive(inc):
    return np.concatenate([np.zeros(1, inc.dtype), inc[:-1]])


def tree_sum(x):
    """The butterfly sum over the lanes (warp_allsum)."""
    v = np.array(x, dtype=float)
    d = len(v) // 2
    while d > 0:
        v = v + v[np.arange(len(v)) ^ d]
        d //= 2
    return v[0]


def trunc_rw(ids, a, wmin):
    x = min(max(a - ids, 0.0), 1.0)
    return max(0.5 * (1.0 - math.cos(math.pi * x)), wmin)


def one_minus(a):
    return min(max(1.0 - a, 1e-7), 1.0 - 1e-7)


def composite_groups(opt, trunc_a, offsets, smp, sig=None, window=0, mode_first=False,
                     cache_K=0, bg_rgb=None):
    """K4's kernel, transcribed: ray r on G lanes, lane k on entry base + k."""
    f = {k: smp[k].numpy() for k in ("t", "alpha", "rgb", "snorm", "loss_e")}
    t, alpha, rgbs, snorm, loss_e = f["t"], f["alpha"], f["rgb"], f["snorm"], f["loss_e"]
    contrib, fake = smp["contrib"].numpy(), smp["fake"].numpy()
    counted = smp["counted"].numpy().astype(np.int64)
    S0, M = t.shape
    n_le = loss_e.shape[0]
    off = offsets.numpy()
    B = len(off) - 1
    stop_on = opt.stop_thresh > 0
    log_stop = math.log(opt.stop_thresh) if stop_on else 0.0
    ta = float(trunc_a)
    weight, live = np.zeros((S0, M)), np.zeros((S0, M), bool)
    win = np.ones(M, bool)
    out = {k: np.zeros(B) for k in ("depth", "log_T", "depth_mode", "depth_med", "sig")}
    out.update(rgb=np.zeros((B, 3)), normal=np.zeros((B, 3)), ray_losses=np.zeros((12, B)),
               n_int=np.zeros(B, np.int64))
    cache = {k: np.zeros((B, max(cache_K, 1))) for k in ("ts", "alphas", "weights")}
    cache["fake"] = np.zeros((B, max(cache_K, 1)), bool)
    cache["n"], cache["med"] = np.zeros(B, np.int64), np.zeros(B)

    def alpha_trunc(i, c):
        return alpha[i] * trunc_rw(c - int(fake[i]), ta, opt.trunc_vol_weight_min) \
            if opt.truncated_vol_render else alpha[i]

    for r in range(B):
        e0, e1 = int(off[r]), int(off[r + 1])
        cnt_c = ncache_c = 0
        e_dead, pre_c = e1, 0.0
        W_c = WT_c = A_c = AT_c = 0.0
        t_ref, ref_set = 0.0, False
        lane = {k: np.zeros(G) for k in ("depth", "totW", "ld", "lda", "ent", "enta", "sp",
                                         "spw", "spww")}
        lane_rgb, lane_nrm, lane_le = np.zeros((G, 3)), np.zeros((G, 3)), np.zeros((G, 5))
        cnt_win, t_sig = np.zeros(G, np.int64), np.full(G, np.inf)
        wm, tm, em = np.zeros(G), np.full(G, -np.inf), np.full(G, 2 ** 31 - 1)
        for base in range(e0, e1, G):
            es = base + np.arange(G)
            valid = es < e1
            nc = np.array([counted[:, e].sum() if v else 0 for e, v in zip(es, valid)])
            cnt0 = np.full(G, cnt_c)
            if opt.truncated_vol_render:
                inc = scan(nc)
                cnt0 = cnt_c + exclusive(inc)
                cnt_c += int(inc[-1])
            before_kill = valid & (es < e_dead)
            la, t_first, n_c = np.zeros(G), np.zeros(G), np.zeros(G, np.int64)
            for k in np.flatnonzero(before_kill):
                c = int(cnt0[k])
                for s in range(S0):
                    i = (s, es[k])
                    if contrib[i]:
                        la[k] += math.log(one_minus(alpha_trunc(i, c)))
                        if n_c[k] == 0:
                            t_first[k] = t[i]
                        n_c[k] += 1
                    c += counted[i]
            la_inc = scan(la)
            e_pre = pre_c + exclusive(la_inc)
            dead = before_kill & ~(e_pre > log_stop) if stop_on else np.zeros(G, bool)
            if dead.any():  # the ballot: the first dead lane, every later entry dead
                k = int(np.flatnonzero(dead)[0])
                e_dead, pre_c = base + k, e_pre[k]
            else:
                pre_c = pre_c + la_inc[-1]
            if not ref_set and (n_c > 0).any():
                t_ref, ref_set = t_first[np.flatnonzero(n_c > 0)[0]], True
            alive = valid & (es < e_dead)
            pos = np.zeros(G, np.int64)
            if cache_K > 0:
                inc = scan(np.where(alive, n_c, 0))
                pos = ncache_c + exclusive(inc)
                ncache_c += int(inc[-1])
            W, WT, A, AT = (np.zeros(G) for _ in range(4))
            for k in np.flatnonzero(valid):
                e = es[k]
                in_win = True
                if window > 0:
                    start = e0 + ((e - e0) // window) * window
                    in_win = start == e0 or start < e_dead
                win[e] = in_win
                local, w_best, t_best, c = 0.0, -1.0, 0.0, int(cnt0[k])
                for s in range(S0):
                    i = (s, e)
                    ct = bool(alive[k] and contrib[i])
                    ac = alpha_trunc(i, c) if ct else 0.0
                    c += counted[i]
                    om = one_minus(ac) if ct else 1.0
                    w = math.exp(min(e_pre[k] + local, 0.0)) * (1.0 - om) if ct else 0.0
                    local += math.log(om)
                    weight[i], live[i] = w, ct
                    if w > w_best:
                        w_best, t_best = w, t[i]
                    if mode_first and w > wm[k]:
                        wm[k], tm[k], em[k] = w, t[i], e - e0
                    if not ct:
                        continue
                    lane["totW"][k] += w
                    lane_rgb[k] += w * rgbs[:, s, e]
                    lane_nrm[k] += w * snorm[:, s, e]
                    lane["depth"][k] += w * t[i]
                    if sig is not None and not fake[i] and alpha[i] > sig:
                        t_sig[k] = min(t_sig[k], t[i])
                    if pos[k] < cache_K:
                        row = (r, pos[k])
                        cache["ts"][row], cache["alphas"][row] = t[i], ac
                        cache["weights"][row], cache["fake"][row] = w, fake[i]
                    pos[k] += 1
                    logsig = math.log(max(-math.log(max(1.0 - ac, 1e-8)), 1e-8))
                    lane["sp"][k] += logsig
                    lane["spw"][k] += logsig * w
                    lane["spww"][k] += w
                    if not (opt.fake_sample_l_dist or not fake[i]):
                        continue
                    ts = t[i] - t_ref
                    lane["lda"][k] += ac * (ts * A[k] - AT[k])
                    A[k] += ac
                    AT[k] += ac * ts
                    lane["ld"][k] += w * (ts * W[k] - WT[k])
                    W[k] += w
                    WT[k] += w * ts
                    if w > 0:
                        lane["ent"][k] += -w * math.log(max(w, 1e-8))
                    if ac > 0:
                        lane["enta"][k] += -ac * math.log(max(ac, 1e-8))
                if not mode_first:
                    if w_best > wm[k]:
                        wm[k], tm[k] = w_best, t_best
                    elif w_best == wm[k] and w_best > 0:
                        tm[k] = max(tm[k], t_best)
                if in_win:
                    cnt_win[k] += nc[k]
                    lane_le[k, :n_le] += loss_e[:, e]
            # l_dist's cross terms with the entries before
            Wp, WTp = W_c + exclusive(scan(W)), WT_c + exclusive(scan(WT))
            Ap, ATp = A_c + exclusive(scan(A)), AT_c + exclusive(scan(AT))
            lane["ld"] += Wp * WT - WTp * W
            lane["lda"] += Ap * AT - ATp * A
            W_c, WT_c = W_c + scan(W)[-1], WT_c + scan(WT)[-1]
            A_c, AT_c = A_c + scan(A)[-1], AT_c + scan(AT)[-1]

        # the median's sweep over the live entries' weights
        totW = tree_sum(lane["totW"])
        t_med = np.inf
        if totW > 1e-12:
            preW_c = 0.0
            for base in range(e0, e_dead, G):
                es = base + np.arange(G)
                valid = es < e_dead
                ws = np.array([weight[:, e].sum() if v else 0.0 for e, v in zip(es, valid)])
                inc = scan(ws)
                pw = preW_c + exclusive(inc)
                for k in np.flatnonzero(valid):
                    for s in range(S0):
                        i = (s, es[k])
                        if contrib[i] and pw[k] + weight[i] >= 0.5 * totW:
                            t_med = min(t_med, t[i])
                        pw[k] += weight[i]
                preW_c += inc[-1]
        if cache_K > 0:
            n = min(ncache_c, cache_K)
            cw = cache["weights"][r, :n]
            tot = sum(tree_sum(np.pad(cw[k0:k0 + G], (0, G - len(cw[k0:k0 + G]))))
                      for k0 in range(0, cache_K, G))
            cum = np.cumsum(cw)
            hit = np.flatnonzero(cum >= max(0.5 * tot, 1e-12))
            cache["n"][r] = n
            cache["med"][r] = cache["ts"][r, hit[0]] if tot > 0 and hit.size else 0.0
        # the mode: the larger weight; on a tie the larger t (packed) or the earlier entry
        if mode_first:
            best = max(range(G), key=lambda k: (wm[k], -em[k]))
            mode = tm[best]
        else:
            wmax = wm.max()
            mode = tm[wm == wmax].max() if wmax > 0 else -np.inf
        T = math.exp(pre_c)
        bg = bg_rgb[r].numpy() if bg_rgb is not None else opt.background_brightness
        out["rgb"][r] = [tree_sum(lane_rgb[:, c]) for c in range(3)] + T * np.asarray(bg)
        out["normal"][r] = [tree_sum(lane_nrm[:, c]) for c in range(3)]
        out["depth"][r], out["log_T"][r] = tree_sum(lane["depth"]), pre_c
        out["depth_mode"][r] = mode if np.isfinite(mode) else 0.0
        out["depth_med"][r] = t_med if np.isfinite(t_med) else 0.0
        out["sig"][r] = t_sig.min() if np.isfinite(t_sig.min()) else 0.0
        out["n_int"][r] = cnt_win.sum()
        out["ray_losses"][:, r] = [tree_sum(lane[k]) for k in ("ld", "lda", "ent", "enta", "sp",
                                                                "spw", "spww")] + \
            [tree_sum(lane_le[:, c]) for c in range(5)]
    return out, weight, live, win, cache


def plain_inputs(a, opt, o, d):
    """The port's float64 pool and plain phase-B samples of these rays."""
    g = SparseGrid.from_numpy(a, device="cpu")
    rays = pt.Rays(t64(o), t64(d))
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, _ = S._prep(g, rays, opt)
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    pool = S._compact_crossings_plain(g.reso, origins, dirs, tn, tx, S.occupancy_words(g, opt))
    smp = S._voxel_samples_plain(g, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(g))
    return g, pool, smp


def dense_inputs(g, opt, o, d):
    """The port's float64 dense-walk pool and its plain phase-B samples."""
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, words, _ = S._begin(
        g, pt.Rays(t64(o), t64(d)), opt, None)
    pool, _ = S.dense_walk(g, origins, dirs, tnear, tmax, ray_ok, words, S.max_voxels_for(g))
    smp = S._voxel_samples_plain(g, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(g))
    return pool, smp


def assert_like_plain(got, cp, keys=("rgb", "normal", "depth", "log_T", "ray_losses")):
    mapping = {"rgb": "rgb", "normal": "normal", "depth": "depth", "log_T": "log_T",
               "ray_losses": "ray_losses", "depth_mode": "depth_mode", "depth_med": "depth_med"}
    for k in keys + ("depth_mode", "depth_med"):
        np.testing.assert_allclose(got[k], cp[mapping[k]].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["n_int"], cp["n_intersections"].numpy())


PACKED_CASES = {
    # a stop_thresh kill mid-ray on dense rays, with truncation and fake samples
    "kill": (lambda: dense_grid(16), dict(stop_thresh=0.3, truncated_vol_render=True,
                                           surf_fake_sample=True, limited_fake_sample=False,
                                           surf_fake_sample_min_vox_len=0.0)),
    # truncation and fake samples without a kill, l_dist without the fakes
    "trunc_fake": (lambda: dense_grid(16), dict(truncated_vol_render=True,
                                                 trunc_vol_weight_min=1e-10,
                                                 surf_fake_sample=True, limited_fake_sample=False,
                                                 surf_fake_sample_min_vox_len=0.0,
                                                 fake_sample_l_dist=False)),
    # one level set, no options: the serving chunk's shape of pool
    "plain": (lambda: np_grid(16, seed=3, prune=0.2), dict()),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_group_decomposition_matches_plain_and_jax(case):
    make, kw = PACKED_CASES[case]
    a = make()
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    g, pool, smp = plain_inputs(a, opt, o, d)
    n_e = (pool.offsets[1:] - pool.offsets[:-1]).numpy()
    assert n_e.max() > (2 * G if case != "plain" else 1)  # rays span three groups or more
    bg = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (64, 3)))
    got, weight, live, _, _ = composite_groups(opt, g.truncated_vol_render_a, pool.offsets, smp,
                                               sig=0.2, bg_rgb=bg)
    cp = S._composite_plain(opt, g.truncated_vol_render_a, pool.offsets, smp, 0.2, bg_rgb=bg)
    assert_like_plain(got, cp)
    np.testing.assert_allclose(weight, cp["weight"].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(live, cp["live"].numpy())
    np.testing.assert_allclose(got["sig"], cp["depth_sigma_thresh"].numpy(), rtol=RTOL, atol=ATOL)
    if opt.stop_thresh > 0:  # some rays die with entries after the kill
        dead_rays = [r for r in range(64) if live[:, pool.offsets[r]:pool.offsets[r + 1]].any()
                     and not live[:, int(pool.offsets[r + 1]) - 1].any()]
        assert len(dead_rays) > 3
    if case != "kill":
        return
    # the JAX package's dense renderer on the same grid, rays and options,
    # against the transcription under its walk's rules (a count window of
    # one entry, the first-maximum mode, a 3-sample cache) on the port's
    # dense-walk pool: one case, as JAX's first call in a process compiles
    # (~7 s on the CPU; its packed renderer's ~30 s)
    pool_d, smp_d = dense_inputs(g, opt, o, d)
    got_d, _, _, _, cache_d = composite_groups(opt, g.truncated_vol_render_a, pool_d.offsets,
                                               smp_d, window=1, mode_first=True, cache_K=3)
    ref = JS.volume_render_surface(jax_grid(a), at.Rays(jnp.asarray(o), jnp.asarray(d)),
                                   at.RenderOptions(**{**BASE, **kw}), cache_size=3)
    for k, jk in (("rgb", "rgb"), ("depth", "depth"), ("normal", "normal"),
                  ("log_T", "log_transmit"), ("depth_mode", "depth_mode")):
        np.testing.assert_allclose(got_d[k], np.asarray(ref[jk]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(cache_d["med"], np.asarray(ref["depth_med"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(cache_d["n"], np.asarray(ref["cache"]["n_cached"]))
    np.testing.assert_array_equal(got_d["n_int"], np.asarray(ref["n_intersections"]))
    for row, k in enumerate(S._RAY_LOSS_KEYS):
        np.testing.assert_allclose(got_d["ray_losses"][row], np.asarray(ref["ray_losses"][k]),
                                   rtol=1e-8, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("window,cache_K", [(2, 4), (1, 3)])
def test_group_decomposition_matches_plain_walk_rules(window, cache_K):
    """The dense and compact renderers' rules: the count window after a
    kill, the first-maximum mode and the first-K cache (both K overflow)."""
    a = dense_grid(16)
    opt = pt.RenderOptions(**{**BASE, "stop_thresh": 0.3, "truncated_vol_render": True,
                              "surf_fake_sample": True, "limited_fake_sample": True})
    o, d = np_rays(64, seed=4)
    g, pool, smp = plain_inputs(a, opt, o, d)
    got, weight, live, win, cache = composite_groups(
        opt, g.truncated_vol_render_a, pool.offsets, smp, window=window, mode_first=True,
        cache_K=cache_K)
    cp = S._composite_plain(opt, g.truncated_vol_render_a, pool.offsets, smp, None, window, True,
                            cache_K)
    assert_like_plain(got, cp)
    np.testing.assert_array_equal(live, cp["live"].numpy())
    assert not win.all()  # entries past a pass that starts dead
    c = cp["cache"]
    np.testing.assert_array_equal(cache["n"], c["n_cached"].numpy())
    assert (cache["n"] == cache_K).any()
    np.testing.assert_array_equal(cache["fake"], c["fake_mask"].numpy())
    for k, ck in (("ts", "ts"), ("alphas", "alphas"), ("weights", "weights")):
        np.testing.assert_allclose(cache[k], c[ck].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(cache["med"], cp["cache_med"].numpy(), rtol=RTOL, atol=ATOL)
