"""K5a's decomposition on the CPU: a float64 numpy transcription of the
backward kernel's arithmetic (csrc/backward.cu, backward_ray_kernel), a ray
as groups of G lanes on consecutive pool entries, held against autograd of
the port's plain compositor and, on one case, against jax.grad of the JAX
package's packed renderer (jitted, its first call compiles in ~10 s on the CPU).

The transcription follows the kernel group by group. Forward, from the
ray's first group: K4's per-entry values and scans (the truncation index,
the log transmittance at each entry, the stop_thresh kill as the group's
first dead lane), the parked truncated alpha and transmittance, l_dist's
prefix parts with t measured from the ray's first contributing sample, the
picks reduced over the lanes (the mode by both rules with their ties, the
sigma-thresh depth), the median's sweep marking each hit, and the cache
median over the cached columns in groups of G. Backward, from the ray's
last group: every suffix quantity as the entry's own suffix plus an
exclusive suffix scan over the later lanes, carried from the later groups
(l_dist's sums, then each slot's Wbar and abar, then Sigma), the
truncation index and the cache column as the totals less integer suffix
scans. G = 4, so the test rays (up to 13 entries) span up to four groups.

Tolerances: the transcription takes its sums in the kernel's tree order
and the plain version in cumsum order, both in float64, so the cotangents
agree to rounding, rtol 1e-9 / atol 1e-10 (observed ~1e-14 relative); the
picked samples are the same ones, so a pick's cotangent lands on the same
slots exactly. Against JAX the grid's gradients (the transcription's
cotangents through autograd of the port's plain phase B) agree to rtol
1e-7 / atol 1e-10, test_torch_backward.py's tolerance for the plain path.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu.render.surface import volume_render_surface_packed as j_render
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.render import surface as S
from test_torch_composite_order import (PACKED_CASES, exclusive, one_minus, plain_inputs, scan,
                                        tree_sum, trunc_rw)
from test_torch_util import BASE, jax_grid, np_rays, t64

G = 4  # lanes a ray in the transcription
RTOL, ATOL = 1e-9, 1e-10
SIG = 0.2  # the sigma-thresh depth's threshold


def suffix(x):
    """Inclusive suffix over the lanes in the kernel's order (warp_suffix)."""
    return scan(np.asarray(x)[::-1])[::-1]


def exclusive_suffix(suf):
    return np.concatenate([suf[1:], np.zeros(1, suf.dtype)])


def entropy_grad(x):
    cx = max(x, 1e-8)
    return -math.log(cx) - x * (1.0 if x > 1e-8 else 0.5 if x == 1e-8 else 0.0) / cx


def logsig_grad(a):
    om = 1.0 - a
    u = max(om, 1e-8)
    v = -math.log(u)
    lo = 1.0 if v > 1e-8 else (0.5 if v == 1e-8 else 0.0)
    lo_om = 1.0 if om > 1e-8 else (0.5 if om == 1e-8 else 0.0)
    return lo / max(v, 1e-8) / u * lo_om


def clip_grad(x, lo, hi):
    return 1.0 if lo < x < hi else (0.5 if x in (lo, hi) else 0.0)


def backward_groups(opt, trunc_a, offsets, smp, g_rgb, g_rl, out=None, mode_first=False,
                    cache_K=0, g_cache=None, bg_rgb=None, dirs=None, rscale=None):
    """K5a's kernel, transcribed: ray r on G lanes, lane k on entry base + k.
    ``out``: the output cotangents by name (depth, normal, log_T, mode, med,
    cache_med, sig, pts, t, alpha, weight, live_alpha), as the kernel's
    second instantiation takes them. Returns d_alpha, d_t (S0, M), d_col and
    d_snorm (3, S0, M)."""
    f = {k: smp[k].detach().numpy() for k in ("t", "alpha", "rgb", "snorm")}
    t, alpha, rgbs, snorm = f["t"], f["alpha"], f["rgb"], f["snorm"]
    contrib, fake = smp["contrib"].numpy(), smp["fake"].numpy()
    counted = smp["counted"].numpy().astype(np.int64)
    S0, M = t.shape
    off = offsets.numpy()
    B = len(off) - 1
    out = out or {}
    stop_on = opt.stop_thresh > 0
    log_stop = math.log(opt.stop_thresh) if stop_on else 0.0
    ta, wmin = float(trunc_a), opt.trunc_vol_weight_min
    park_a, park_T = np.full((S0, M), -1.0), np.zeros((S0, M))
    mark = np.zeros((S0, M), bool)
    d_alpha, d_t = np.zeros((S0, M)), np.zeros((S0, M))
    d_c0, d_c1 = np.zeros((S0, M)), np.zeros((S0, M))
    d_col, d_snorm = np.zeros((3, S0, M)), np.zeros((3, S0, M))

    def alpha_trunc(i, c):
        return alpha[i] * trunc_rw(c - int(fake[i]), ta, wmin) if opt.truncated_vol_render \
            else alpha[i]

    def inc_of(i):
        return bool(opt.fake_sample_l_dist or not fake[i])

    def parked_weight(i):
        return 0.0 if park_a[i] < 0 else park_T[i] * (1.0 - one_minus(park_a[i]))

    def dt_out_of(r, i, e, s):
        dt = out["t"][i] if "t" in out else 0.0
        if "pts" in out:
            gp = out["pts"][e * S0 + s]
            dt += sum(gp[c] * dirs[r, c] * rscale[c] for c in range(3))
        return dt

    for r in range(B):
        e0, e1 = int(off[r]), int(off[r + 1])
        g_ld, g_lda, g_ent, g_enta, g_sls, g_slsw = (g_rl[k, r] for k in range(6))
        # forward, as K4
        cnt_c = live_c = 0
        e_dead, pre_c = e1, 0.0
        W_c = WT_c = A_c = AT_c = 0.0
        t_ref, ref_set = 0.0, False
        lane_w, wm, tm, nm = np.zeros(G), np.zeros(G), np.full(G, -np.inf), np.zeros(G, int)
        wf, ef, i_f = np.zeros(G), np.full(G, 2 ** 31 - 1), [None] * G
        t_sig, n_sig = np.full(G, np.inf), np.zeros(G, int)
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
            if not ref_set and (n_c > 0).any():
                t_ref, ref_set = t_first[np.flatnonzero(n_c > 0)[0]], True
            la_inc = scan(la)
            e_pre = pre_c + exclusive(la_inc)
            dead = before_kill & ~(e_pre > log_stop) if stop_on else np.zeros(G, bool)
            if dead.any():
                k = int(np.flatnonzero(dead)[0])
                e_dead, pre_c = base + k, e_pre[k]
            else:
                pre_c = pre_c + la_inc[-1]
            alive = valid & (es < e_dead)
            live_c += int(n_c[alive].sum())
            W, WT, A, AT = (np.zeros(G) for _ in range(4))
            for k in np.flatnonzero(valid):
                e = es[k]
                local, w_best, t_best, c = 0.0, -1.0, 0.0, int(cnt0[k])
                for s in range(S0):
                    i = (s, e)
                    ct = bool(alive[k] and contrib[i])
                    ac = alpha_trunc(i, c) if ct else 0.0
                    c += counted[i]
                    om = one_minus(ac) if ct else 1.0
                    T = math.exp(min(e_pre[k] + local, 0.0))
                    w = T * (1.0 - om) if ct else 0.0
                    local += math.log(om)
                    park_a[i], park_T[i] = (ac if ct else -1.0), T
                    if w > w_best:
                        w_best, t_best = w, t[i]
                    if mode_first and w > wf[k]:
                        wf[k], ef[k], i_f[k] = w, e - e0, i
                    if not ct:
                        continue
                    lane_w[k] += w
                    if not fake[i] and alpha[i] > SIG:
                        if t[i] < t_sig[k]:
                            t_sig[k], n_sig[k] = t[i], 1
                        elif t[i] == t_sig[k]:
                            n_sig[k] += 1
                    if not inc_of(i):
                        continue
                    ts = t[i] - t_ref
                    W[k] += w
                    WT[k] += w * ts
                    A[k] += ac
                    AT[k] += ac * ts
                if not mode_first:
                    if w_best > wm[k]:
                        wm[k], tm[k], nm[k] = w_best, t_best, 1
                    elif w_best == wm[k] and w_best > 0:
                        if t_best > tm[k]:
                            tm[k], nm[k] = t_best, 1
                        elif t_best == tm[k]:
                            nm[k] += 1
            # l_dist's prefix parts
            Aw, Sw = W_c + exclusive(scan(W)), WT_c + exclusive(scan(WT))
            Aa, Sa = A_c + exclusive(scan(A)), AT_c + exclusive(scan(AT))
            W_c, WT_c = W_c + scan(W)[-1], WT_c + scan(WT)[-1]
            A_c, AT_c = A_c + scan(A)[-1], AT_c + scan(AT)[-1]
            for k in np.flatnonzero(valid):
                for s in range(S0):
                    i = (s, es[k])
                    at_ = park_a[i]
                    if at_ < 0:
                        continue
                    if not inc_of(i):
                        d_t[i] = 0.0
                        continue
                    w, ts = parked_weight(i), t[i] - t_ref
                    d_t[i] = g_ld * w * Aw[k] + g_lda * at_ * Aa[k]
                    d_c0[i] = g_ld * (ts * Aw[k] - Sw[k])
                    d_c1[i] = g_lda * (ts * Aa[k] - Sa[k])
                    Aw[k] += w
                    Sw[k] += w * ts
                    Aa[k] += at_
                    Sa[k] += at_ * ts

        # the picks, reduced over the lanes
        g_mode = g_med = g_sig = g_cmed = 0.0
        if mode_first:
            best = max(range(G), key=lambda k: (wf[k], -ef[k]))
            wmax, i_mode = wf[best], i_f[best]
        else:
            wmax = wm.max()
            t_mode = tm[wm == wmax].max()
            n_mode = int(nm[(wm == wmax) & (tm == t_mode)].sum())
        if "mode" in out and wmax > 0:
            g_mode = out["mode"][r] / (1 if mode_first else n_mode)
        t_sig_r = t_sig.min()
        if "sig" in out and n_sig[t_sig == t_sig_r].sum() > 0:
            g_sig = out["sig"][r] / n_sig[t_sig == t_sig_r].sum()
        if "med" in out:
            totW = tree_sum(lane_w)
            thr = 0.5 * totW
            e_end = e_dead if totW > 1e-12 else e0
            preW_c, t_med, n_med = 0.0, np.inf, 0
            for base in range(e0, e_end, G):
                es = base + np.arange(G)
                valid = es < e_end
                ws = np.zeros(G)
                for k in np.flatnonzero(valid):
                    for s in range(S0):
                        ws[k] += parked_weight((s, es[k]))
                inc = scan(ws)
                pw = preW_c + exclusive(inc)
                for k in np.flatnonzero(valid):
                    for s in range(S0):
                        i = (s, es[k])
                        w = parked_weight(i)
                        if contrib[i] and pw[k] + w >= thr:
                            mark[i] = True
                            if t[i] < t_med:
                                t_med, n_med = t[i], 1
                            elif t[i] == t_med:
                                n_med += 1
                        pw[k] += w
                preW_c += inc[-1]
            if n_med > 0:
                g_med = out["med"][r] / n_med
        k_med = -1
        if "cache_med" in out and cache_K > 0:
            n_cached = min(live_c, cache_K)
            cols = [parked_weight((s, e)) for e in range(e0, e1) for s in range(S0)
                    if park_a[s, e] >= 0][:n_cached]
            cols = np.pad(np.array(cols, float), (0, -(-cache_K // G) * G - n_cached))
            tot = sum(tree_sum(cols[k0:k0 + G]) for k0 in range(0, cache_K, G))
            thr, cum, hit = max(0.5 * tot, 1e-12), 0.0, -1
            for k0 in range(0, cache_K, G):
                inc = scan(cols[k0:k0 + G])
                h = [j for j in range(G) if k0 + j < n_cached and cum + inc[j] >= thr]
                if hit < 0 and h:
                    hit = k0 + h[0]
                cum += inc[-1]
            k_med = hit if tot > 0 and hit >= 0 else -1
            if k_med >= 0:
                g_cmed = out["cache_med"][r]
        gd = out["depth"][r] if "depth" in out else 0.0
        gn = out["normal"][r] if "normal" in out else np.zeros(3)

        # backward, from the last group
        Gc = g_rgb[r]
        bg = bg_rgb[r] if bg_rgb is not None else np.full(3, opt.background_brightness)
        Sig_c = float(Gc[0] * bg[0] + Gc[1] * bg[1] + Gc[2] * bg[2]) * math.exp(pre_c)
        if "log_T" in out:
            Sig_c += out["log_T"][r]
        Aw_c = Sw_c = Aa_c = Sa_c = 0.0
        cnt_hi, live_hi = cnt_c, live_c
        for base in list(range(e0, e1, G))[::-1]:
            es = base + np.arange(G)
            valid = es < e1
            nc, nl = np.zeros(G, np.int64), np.zeros(G, np.int64)
            W, WT, A, AT = (np.zeros(G) for _ in range(4))
            for k in np.flatnonzero(valid):
                for s in range(S0):
                    i = (s, es[k])
                    nc[k] += counted[i]
                    if park_a[i] < 0:
                        continue
                    nl[k] += 1
                    if not inc_of(i):
                        continue
                    w, ts = parked_weight(i), t[i] - t_ref
                    W[k] += w
                    WT[k] += w * ts
                    A[k] += park_a[i]
                    AT[k] += park_a[i] * ts
            suf_nc, suf_nl = suffix(nc), suffix(nl)
            cnt0, live0 = cnt_hi - suf_nc, live_hi - suf_nl
            cnt_hi, live_hi = cnt_hi - suf_nc[0], live_hi - suf_nl[0]
            sW, sWT, sA, sAT = suffix(W), suffix(WT), suffix(A), suffix(AT)
            Aw, Sw = Aw_c + exclusive_suffix(sW), Sw_c + exclusive_suffix(sWT)
            Aa, Sa = Aa_c + exclusive_suffix(sA), Sa_c + exclusive_suffix(sAT)
            Aw_c, Sw_c, Aa_c, Sa_c = Aw_c + sW[0], Sw_c + sWT[0], Aa_c + sA[0], Sa_c + sAT[0]
            X = np.zeros(G)
            Wbars, abars = {}, {}
            for k in np.flatnonzero(valid):
                e = es[k]
                s_best = -1
                if g_mode != 0 and not mode_first:
                    ws_e = [parked_weight((s, e)) for s in range(S0)]
                    sb = int(np.argmax(ws_e))  # the first maximum
                    if ws_e[sb] == wmax and ws_e[sb] > 0 and t[sb, e] == t_mode:
                        s_best = sb
                kc = int(live0[k] + nl[k])
                for s in range(S0 - 1, -1, -1):
                    i = (s, e)
                    at_ = park_a[i]
                    if at_ < 0:
                        continue
                    T, om = park_T[i], one_minus(at_)
                    w = T * (1.0 - om)
                    inc = inc_of(i)
                    wi, a = (w, at_) if inc else (0.0, 0.0)
                    ts = t[i] - t_ref
                    Wbar = float(Gc[0] * rgbs[0][i] + Gc[1] * rgbs[1][i] + Gc[2] * rgbs[2][i])
                    abar = (g_sls + g_slsw * w) * logsig_grad(at_)
                    dt = d_t[i]
                    if inc:
                        Wbar += d_c0[i] + g_ld * (Sw[k] - ts * Aw[k])
                        if wi > 0:
                            Wbar += g_ent * entropy_grad(wi)
                        abar += d_c1[i] + g_lda * (Sa[k] - ts * Aa[k])
                        if a > 0:
                            abar += g_enta * entropy_grad(a)
                        dt = dt - g_ld * wi * Aw[k] - g_lda * a * Aa[k]
                    kc -= 1
                    if g_cache is not None and kc < cache_K:
                        Wbar += g_cache[2][r, kc]
                        abar += g_cache[1][r, kc]
                        dt += g_cache[0][r, kc]
                    Wbar += gd * t[i]
                    dt += gd * w + dt_out_of(r, i, e, s)
                    Wbar += float(np.dot(gn, snorm[:, s, e]))
                    if "weight" in out:
                        Wbar += out["weight"][i]
                    if "live_alpha" in out:
                        abar += out["live_alpha"][i]
                    if g_mode != 0 and ((i == i_mode) if mode_first else s == s_best):
                        dt += g_mode
                    if g_med != 0 and mark[i] and t[i] == t_med:
                        dt += g_med
                    if g_sig != 0 and not fake[i] and alpha[i] > SIG and t[i] == t_sig_r:
                        dt += g_sig
                    if g_cmed != 0 and kc == k_med:
                        dt += g_cmed
                    Wbars[i], abars[i], d_t[i] = Wbar, abar, dt
                    X[k] += Wbar * w
                    Aw[k] += wi
                    Sw[k] += wi * ts
                    Aa[k] += a
                    Sa[k] += a * ts
            sX = suffix(X)
            Sig_e = Sig_c + exclusive_suffix(sX)
            Sig_c = Sig_c + sX[0]
            for k in np.flatnonzero(valid):
                e, Sig_l, c = es[k], 0.0, int(cnt0[k] + nc[k])
                for s in range(S0 - 1, -1, -1):
                    i = (s, e)
                    c -= counted[i]
                    at_ = park_a[i]
                    if at_ < 0:
                        d_alpha[i] = out["alpha"][i] if "alpha" in out else 0.0
                        d_t[i] = dt_out_of(r, i, e, s)
                        continue
                    T, om = park_T[i], one_minus(at_)
                    w = T * (1.0 - om)
                    d_om = -T * Wbars[i] + (Sig_e[k] + Sig_l) / om
                    d_at = abars[i] - d_om * clip_grad(1.0 - at_, 1e-7, 1.0 - 1e-7)
                    rw = trunc_rw(c - int(fake[i]), ta, wmin) if opt.truncated_vol_render else 1.0
                    d_alpha[i] = d_at * rw + (out["alpha"][i] if "alpha" in out else 0.0)
                    d_col[:, s, e] = Gc * w
                    d_snorm[:, s, e] = gn * w
                    Sig_l += Wbars[i] * w
    return d_alpha, d_t, d_col, d_snorm


# the cotangents the second instantiation takes, and the plain outputs they
# differentiate: per ray, then per slot
RAY_OUT = {"depth": "depth", "log_T": "log_T", "mode": "depth_mode", "med": "depth_med",
           "sig": "depth_sigma_thresh", "cache_med": "cache_med"}
SLOT_OUT = {"t": "t", "alpha": "alpha", "weight": "weight", "live_alpha": "live_alpha"}


def plain_cotangents(opt, trunc_a, offsets, smp, g_rgb, g_rl, out, mode, g_cache, bg_rgb,
                     dirs, rscale, pool):
    """d loss / d (pre-truncation alpha, t, clipped colour, normal) by
    autograd of the port's plain compositor on the same slots, for the loss
    sum_k <g_k, output_k> over the transcription's cotangents."""
    leaves = {k: smp[k].detach().clone().requires_grad_(True) for k in ("alpha", "t", "rgb",
                                                                        "snorm")}
    s2 = dict(smp, **leaves)
    comp = S._composite_plain(opt, trunc_a, offsets, s2, SIG, *mode, bg_rgb=bg_rgb)
    comp.update(t=leaves["t"], alpha=leaves["alpha"])
    loss = (comp["rgb"] * t64(g_rgb)).sum() + (comp["ray_losses"] * t64(g_rl)).sum()
    for k, key in RAY_OUT.items():
        if k in out:
            loss = loss + (comp[key] * t64(out[k])).sum()
    if "normal" in out:
        loss = loss + (comp["normal"] * t64(out["normal"])).sum()
    for k, key in SLOT_OUT.items():
        if k in out:
            x = comp[key] if key != "live_alpha" else comp["live_alpha"]
            loss = loss + (x * t64(out[k])).sum()
    if "pts" in out:
        rid = pool.ray_id.long()
        p = (t64(np.asarray(dirs))[rid].T[:, None, :] * leaves["t"][None])  # (3, S0, M)
        p = p * t64(np.asarray(rscale))[:, None, None]
        loss = loss + (p.permute(2, 1, 0).reshape(-1, 3) * t64(out["pts"])).sum()
    if g_cache is not None:
        for g, key in zip(g_cache, ("ts", "alphas", "weights")):
            loss = loss + (comp["cache"][key] * t64(g)).sum()
    gs = torch.autograd.grad(loss, [leaves[k] for k in ("alpha", "t", "rgb", "snorm")],
                             allow_unused=True)
    return [np.zeros(tuple(leaves[k].shape)) if g is None else g.numpy()
            for k, g in zip(("alpha", "t", "rgb", "snorm"), gs)]


def draw_cotangents(rng, B, S0, M, every, walk):
    g_rgb = rng.standard_normal((B, 3))
    g_rl = rng.standard_normal((12, B)) * 0.1
    out = {}
    if every:
        out = {k: rng.standard_normal(B) for k in ("depth", "log_T", "mode", "sig")}
        out["normal"] = rng.standard_normal((B, 3))
        out.update({k: rng.standard_normal((S0, M)) for k in ("t", "alpha", "weight")})
        if walk:
            out["cache_med"] = rng.standard_normal(B)
            out["live_alpha"] = rng.standard_normal((S0, M))
        else:
            out["med"] = rng.standard_normal(B)
            out["pts"] = rng.standard_normal((M * S0, 3))
    return g_rgb, g_rl, out


# (case of test_torch_composite_order, the walks' rules, every output's cotangent)
CASES = [(c, walk, every) for c in sorted(PACKED_CASES) for walk in (False, True)
         for every in (False, True)]


@pytest.mark.parametrize("case,walk,every", CASES)
def test_backward_decomposition_matches_plain_autograd(case, walk, every):
    """The transcription against autograd of the plain compositor, by the
    packed renderer's rules and the walks' (a count window of 2 entries,
    the first-maximum mode, a 3-sample cache, which overflows, with its
    cotangents), rgb and the ray losses alone and with every output's
    cotangent (the second instantiation's), on composite_order's rays:
    kills mid-ray ("kill"), truncation with fake samples out of l_dist
    ("trunc_fake"), one level set ("plain")."""
    make, kw = PACKED_CASES[case]
    opt = pt.RenderOptions(**{**BASE, **kw})
    o, d = np_rays(64, seed=4)
    g, pool, smp = plain_inputs(make(), opt, o, d)
    S0, M = smp["t"].shape
    B = 64
    rng = np.random.default_rng(11)
    g_rgb, g_rl, out = draw_cotangents(rng, B, S0, M, every, walk)
    mode, K, g_cache = S.PACKED, 0, None
    if walk:
        mode, K = S._Mode(2, True, 3), 3
        g_cache = tuple(rng.standard_normal((B, K)) for _ in range(3))
    bg = rng.uniform(0, 1, (B, 3))
    dirs, rscale = smp["t"].new_tensor(d).numpy(), np.array([0.7, 1.1, 0.9])
    got = backward_groups(opt, g.truncated_vol_render_a, pool.offsets, smp, g_rgb, g_rl, out,
                          walk, K, g_cache, bg, dirs, rscale)
    ref = plain_cotangents(opt, g.truncated_vol_render_a, pool.offsets, smp, g_rgb, g_rl, out,
                           mode, g_cache, t64(bg), dirs, rscale, pool)
    for name, x, y in zip(("d_alpha", "d_t", "d_col", "d_snorm"), got, ref):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(ref[0]).max() > 0 and (np.abs(ref[1]).max() > 0 or not every)
    if opt.stop_thresh > 0:  # kills mid-ray
        comp = S._composite_plain(opt, g.truncated_vol_render_a, pool.offsets, smp, None, *mode)
        assert int(comp["live"].sum()) < int(smp["contrib"].sum())


def test_backward_decomposition_matches_jax_packed_gradients():
    """The transcription's cotangents, chained through autograd of the
    port's plain phase B, against jax.grad of the JAX packed renderer on
    the kill case: rgb, every ray loss that carries a gradient, depth,
    normal, log_transmit and the mode depth."""
    make, kw = PACKED_CASES["kill"]
    a = make()
    opt_kw = {**BASE, **kw}
    opt = pt.RenderOptions(**opt_kw)
    o, d = np_rays(64, seed=4)
    rng = np.random.default_rng(5)
    B = 64
    g_rgb = rng.standard_normal((B, 3))
    g_rl = np.zeros((12, B))
    diff_keys = ("l_dist", "l_dist_a", "l_entropy", "l_entropy_a", "sp_logsig", "sp_logsig_w",
                 "l_inward", "lap_sum")
    for k in diff_keys:
        g_rl[S._RAY_LOSS_KEYS.index(k)] = rng.standard_normal(B) * 0.1
    out = {k: rng.standard_normal(B) for k in ("depth", "log_T", "mode")}
    out["normal"] = rng.standard_normal((B, 3))

    gj = jax_grid(a)
    rays_j = at.Rays(jnp.asarray(o), jnp.asarray(d))
    params = ("density_data", "sh_data", "surface_data", "fake_sample_std")

    def j_loss(*ps):
        r = j_render(gj.replace(**dict(zip(params, ps))), rays_j, at.RenderOptions(**opt_kw),
                     entries_per_ray=48)
        loss = jnp.sum(r["rgb"] * g_rgb) + jnp.sum(r["depth"] * out["depth"])
        loss = loss + jnp.sum(r["normal"] * out["normal"])
        loss = loss + jnp.sum(r["log_transmit"] * out["log_T"])
        loss = loss + jnp.sum(r["depth_mode"] * out["mode"])
        for k in diff_keys:
            loss = loss + jnp.sum(r["ray_losses"][k] * g_rl[S._RAY_LOSS_KEYS.index(k)])
        return loss, r["pool_overflow"]

    (_, overflow), ref = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a[k]) for k in params))
    assert int(overflow) == 0

    gt = SparseGrid.from_numpy(a, device="cpu")
    leaves = [getattr(gt, k).requires_grad_(True) for k in params]
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, _ = S._prep(gt, pt.Rays(t64(o), t64(d)),
                                                                  opt)
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    pool = S._compact_crossings_plain(gt.reso, origins, dirs, tn, tx, S.occupancy_words(gt, opt))
    smp = S._voxel_samples_plain(gt, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(gt))
    d_alpha, d_t, d_col, d_snorm = backward_groups(opt, gt.truncated_vol_render_a.detach(),
                                                   pool.offsets, smp, g_rgb, g_rl, out)
    # the ray losses' per-entry terms (inward, lap) go through loss_e, as K5b takes them
    loss_e = smp["loss_e"]
    ray = pool.ray_id.long()
    g_le = t64(g_rl[7:10])[:, ray]
    got = torch.autograd.grad(
        [smp["alpha"], smp["t"], smp["rgb"], smp["snorm"], loss_e],
        leaves, [t64(d_alpha), t64(d_t), t64(d_col), t64(d_snorm), g_le], allow_unused=True)
    for name, x, r in zip(params, got, ref):
        x = np.zeros_like(np.asarray(r)) if x is None else x.numpy()
        np.testing.assert_allclose(x, np.asarray(r), rtol=1e-7, atol=1e-10, err_msg=name)
    assert np.abs(np.asarray(ref[2])).max() > 0 and abs(float(ref[3][0, 0])) > 0
