// K4: the per-ray compositor.
//
// Replaces the compositor of the JAX package's render/surface.py:
// volume_render_surface_packed (1804-1953) and _finalize (1002-1031). Per
// ray, in (entry, slot) order: the truncated-vol-render reweight by running
// intersection index, the stop_thresh kill of whole entries by the
// transmittance at their entry, weights, rgb/depth/normal, mode depth (the
// largest t among max-weight ties), median depth (the smallest t where the
// running weight reaches half the total), l_dist(_a), l_entropy(_a), the
// sparsity sums, the entries' inward/lap sums, and the background.
//
// Two output options of JAX's compositor (render/surface.py:1899-1907,
// 1997-2014): the sigma-thresh depth, per ray the smallest t of a sample
// that contributes after the stop_thresh kill, is not fake and whose
// pre-truncation alpha is above the threshold (0 where none is), a running
// minimum in the walk; and, for the intersection cloud, each slot's
// contribution flag after the kill (the weight is written anyway), with, for
// the walks' return_samples (surface.py:1052-1062), its truncated alpha.
// intersect_points, a second kernel, writes the world point of every slot
// of every pool entry, entry-major, for that cloud: o + t d of the entry's
// ray, then JAX's grid2world; bound: bytes, one thread per slot.
//
// K11c, the first-K sample cache (render/surface.py:104-118, 951-970,
// 1955-1975) and its median depth (1032-1051): with cache_K > 0 the walk
// writes each ray's first cache_K contributing samples, in (entry, slot)
// order after the stop_thresh kill, as (t, truncated alpha, weight, fake)
// rows of (B, cache_K) zeros, their count, and the t where the running
// cached weight first reaches half the cached total. Two rules of the JAX
// walks come with it for the dense and compact renderers: window > 0
// counts n_intersections and the inward/lap sums only over passes of
// `window` entries that start alive (win, per entry, tells K5b), and
// mode_first puts the mode depth at the first max-weight sample. Bound:
// bytes; the cache adds 13 bytes a cached sample.
//
// Bound: bytes. Each slot is read once (t, alpha, rgb, snorm, flags, about
// 40 bytes) and its weight written once; per ray ~100 bytes out.
//
// Design (the H100): a ray is a group of G = kK4Lanes = 16 lanes (a warp
// holds 2 rays; an empty pool takes one lane a ray), lane k on its ray's
// entry base + k, groups of
// G consecutive entries from the ray's first to its last. A pool holds a
// few entries a ray (~3 on the serving chunk, ~280 on a dense type pool),
// so one thread a ray left the warps idle and the launch as long as the
// longest ray's serial walk; here every running quantity of the serial
// walk is an entry's local value plus an exclusive scan over the group's
// lanes, carried from one group to the next:
//   - the truncation index: an integer scan of the entries' counted slots
//     (exact);
//   - the log transmittance at each entry (stop_thresh's test and the
//     weights' prefix): a scan of the entries' log attenuation; the kill
//     is the group's first lane below the threshold (a ballot), and every
//     later entry is dead whatever its own rounded prefix says;
//   - the cache positions: an integer scan of the live contributing slots;
//   - l_dist(_a): each entry's sum over its own samples plus the cross
//     term A_e sum(x t) - S_e sum(x) of the scans A_e, S_e of sum(x) and
//     sum(x t) over the entries before (t measured from the ray's first
//     contributing sample, which leaves the sum unchanged and keeps its
//     terms small: unshifted, t ~ 700 at 512^3 cancels to 1e-4).
// Every other per-ray quantity is a sum, a minimum or the mode's pick,
// kept per lane and reduced over the group once at the ray's end. The
// median needs the ray's total weight: a second sweep over the ray's live
// entries re-reads the weights each lane wrote, with a scan of the
// entries' weight sums. The float sums are taken in tree order, not the
// serial walk's, so they differ from the plain version by rounding.
#include "common.cuh"

struct CompositeParams {
    const int64_t* offsets;
    int B;
    int64_t M;
    int S0;
    const float* t;
    const float* alpha;
    const bool* contrib;
    const bool* fake;
    const int* counted;
    const float* rgb;
    const float* snorm;
    const float* loss_e;  // (n_le, M): inward, lap, lap count (+ the UDF types' udf-var sum, count)
    int n_le;
    int truncated;
    const float* trunc_a;  // (1,) on the device
    float trunc_wmin;
    int stop_on;
    float log_stop;
    float bg;
    const float* bg_rgb;  // (B, 3) per-ray background colour (K13), or null: bg
    int fake_l_dist;
    float* out_rgb;
    float* depth;
    float* normal;
    float* log_T;
    float* depth_mode;
    float* depth_med;
    int* n_int;
    float* losses;  // (12, B)
    float* weight;  // (S0, M)
    int sig_on;
    float sig_thresh;
    float* depth_sig;  // (B,), written when sig_on
    bool* live;        // (S0, M) or null
    int window;        // K11c: the count window of the JAX walks (0: every entry)
    int mode_first;
    int cache_K;       // 0: no cache
    float* c_ts;       // (B, cache_K)
    float* c_alpha;
    float* c_w;
    bool* c_fake;
    int* n_cached;     // (B,)
    float* cache_med;  // (B,)
    bool* win;         // (M,) or null
    float* live_alpha;  // (S0, M) the truncated alpha where live (return_samples), or null
};

HD float alpha_trunc(const CompositeParams& p, int64_t i, int cnt, float ta) {
    const float a = p.alpha[i];
    return p.truncated ? a * trunc_rw(cnt - (p.fake[i] ? 1 : 0), ta, p.trunc_wmin) : a;
}

#ifdef __CUDACC__
constexpr int kK4Block = 128;
constexpr int kK4MinBlocks = 6;  // blocks an SM the kernel is compiled for (<= 80 registers)

// K4 on the card: ray r on G lanes, lane lg on its entries base + lg
template <int G>
__global__ void __launch_bounds__(kK4Block, kK4MinBlocks) composite_kernel(CompositeParams p) {
    const int lane = threadIdx.x & 31, lg = lane & (G - 1);
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if ((gid - lane) / G >= p.B) return;  // the whole warp is past the last ray
    const int r = (int)(gid / G);
    const bool has_ray = r < p.B;
    const int64_t e0 = has_ray ? p.offsets[r] : 0, e1 = has_ray ? p.offsets[r + 1] : 0;
    const float ta = p.trunc_a[0];
    const int64_t cbase = (int64_t)r * p.cache_K;

    // carried from group to group, the same in every lane of the ray
    int cnt_c = 0, ncache_c = 0;
    int64_t e_dead = e1;  // entries from here on were killed by stop_thresh
    float pre_c = 0.0f;   // log transmittance before the group (at the kill once killed)
    float W_c = 0.0f, WT_c = 0.0f, A_c = 0.0f, AT_c = 0.0f;  // l_dist's prefixes
    // l_dist's origin of t: the ray's first contributing sample (a slot
    // without a root may hold any t), set in the first group that has one
    float t_ref = 0.0f;
    bool ref_set = false;
    // this lane's sums over its own entries
    float rgb[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f}, depth = 0.0f, totW = 0.0f;
    float l_dist = 0.0f, l_dist_a = 0.0f, ent = 0.0f, ent_a = 0.0f;
    float sp_logsig = 0.0f, sp_logsig_w = 0.0f, sp_w = 0.0f;
    float le[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // loss_e's rows over the counted entries
    int cnt_win = 0;
    float t_sig = INFINITY;
    // the mode: the largest weight, its t (and its entry, for mode_first)
    float wm = 0.0f, tm = -INFINITY;
    int em = INT32_MAX;

    for (int64_t base = e0; __any_sync(kFullWarp, base < e1); base += G) {
        const int64_t e = base + lg;
        const bool valid = e < e1;
        // the entry's counted slots, and the truncation index at its first
        int nc = 0;
        if (valid)
            for (int s = 0; s < p.S0; ++s) nc += p.counted[(int64_t)s * p.M + e];
        int cnt0 = cnt_c;
        if (p.truncated) {
            const int inc = warp_prefix<G>(nc, lg);
            cnt0 = cnt_c + warp_exclusive<G>(inc, lg);
            cnt_c = cnt_c + warp_total<G>(inc);
        }
        // the entry's log attenuation over its contributing slots, while
        // the ray lives, and the log transmittance at its entry
        const bool before_kill = valid && e < e_dead;
        float la = 0.0f, t_first = 0.0f;
        int n_contrib = 0;
        if (before_kill) {
            int c = cnt0;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                if (p.contrib[i]) {
                    la = la + logf(one_minus(alpha_trunc(p, i, c, ta)));
                    if (n_contrib++ == 0) t_first = p.t[i];
                }
                c += p.counted[i];
            }
        }
        {
            const unsigned has = segment_bits<G>(__ballot_sync(kFullWarp, n_contrib > 0), lane);
            const float t0 = __shfl_sync(kFullWarp, t_first, has ? __ffs(has) - 1 : 0, G);
            if (!ref_set && has) {
                t_ref = t0;
                ref_set = true;
            }
        }
        const float la_inc = warp_prefix<G>(la, lg);
        const float e_pre = pre_c + warp_exclusive<G>(la_inc, lg);
        const float la_tot = warp_total<G>(la_inc);
        if (p.stop_on) {
            const unsigned dead = segment_bits<G>(
                __ballot_sync(kFullWarp, before_kill && !(e_pre > p.log_stop)), lane);
            const int k = dead ? __ffs(dead) - 1 : 0;
            const float at_kill = __shfl_sync(kFullWarp, e_pre, k, G);
            if (dead) {
                e_dead = base + k;
                pre_c = at_kill;
            } else {
                pre_c = pre_c + la_tot;
            }
        } else {
            pre_c = pre_c + la_tot;
        }
        const bool alive = valid && e < e_dead;
        // the first cache position of the entry's live samples
        int pos = 0;
        if (p.cache_K > 0) {
            const int inc = warp_prefix<G>(alive ? n_contrib : 0, lg);
            pos = ncache_c + warp_exclusive<G>(inc, lg);
            ncache_c = ncache_c + warp_total<G>(inc);
        }
        // K11c's count window: a pass of `window` entries counts when it
        // starts alive (the first pass always)
        bool in_win = true;
        if (p.window > 0) {
            const int64_t start = e0 + ((e - e0) / p.window) * p.window;
            in_win = start == e0 || start < e_dead;
        }

        // the entry's samples; W, WT, A, AT its l_dist sums
        float W = 0.0f, WT = 0.0f, A = 0.0f, AT = 0.0f;
        if (valid) {
            if (p.win) p.win[e] = in_win;
            float local = 0.0f;  // the log attenuation of the entry's slots so far
            float w_best = -1.0f, t_best = 0.0f;
            int c = cnt0;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                const bool ct = alive && p.contrib[i];
                const float ac = ct ? alpha_trunc(p, i, c, ta) : 0.0f;
                c += p.counted[i];
                const float om = ct ? one_minus(ac) : 1.0f;
                const float w = ct ? expf(fminf(e_pre + local, 0.0f)) * (1.0f - om) : 0.0f;
                local = local + logf(om);
                p.weight[i] = w;
                if (p.live) p.live[i] = ct;
                if (p.live_alpha) p.live_alpha[i] = ac;
                const float t = p.t[i];
                if (w > w_best) {  // the entry's first max-weight slot
                    w_best = w;
                    t_best = t;
                }
                if (p.mode_first && w > wm) {  // the lane's first max-weight sample
                    wm = w;
                    tm = t;
                    em = (int)(e - e0);
                }
                if (!ct) continue;
                totW = totW + w;
                for (int k = 0; k < 3; ++k) {
                    rgb[k] = rgb[k] + w * p.rgb[((int64_t)k * p.S0 + s) * p.M + e];
                    nrm[k] = nrm[k] + w * p.snorm[((int64_t)k * p.S0 + s) * p.M + e];
                }
                depth = depth + w * t;
                const bool fk = p.fake[i];
                if (p.sig_on && !fk && p.alpha[i] > p.sig_thresh) t_sig = fminf(t_sig, t);
                if (pos < p.cache_K) {
                    p.c_ts[cbase + pos] = t;
                    p.c_alpha[cbase + pos] = ac;
                    p.c_w[cbase + pos] = w;
                    p.c_fake[cbase + pos] = fk;
                }
                ++pos;
                const float logsig = logf(fmaxf(-logf(fmaxf(1.0f - ac, 1e-8f)), 1e-8f));
                sp_logsig = sp_logsig + logsig;
                sp_logsig_w = sp_logsig_w + logsig * w;
                sp_w = sp_w + w;
                if (!(p.fake_l_dist || !fk)) continue;
                const float ts = t - t_ref;
                l_dist_a = l_dist_a + ac * (ts * A - AT);
                A = A + ac;
                AT = AT + ac * ts;
                l_dist = l_dist + w * (ts * W - WT);
                W = W + w;
                WT = WT + w * ts;
                if (w > 0.0f) ent = ent + -w * logf(fmaxf(w, 1e-8f));
                if (ac > 0.0f) ent_a = ent_a + -ac * logf(fmaxf(ac, 1e-8f));
            }
            if (!p.mode_first) {
                if (w_best > wm) {
                    wm = w_best;
                    tm = t_best;
                } else if (w_best == wm && w_best > 0.0f) {
                    tm = fmaxf(tm, t_best);
                }
            }
            if (in_win) {
                cnt_win += nc;
                for (int k = 0; k < 5; ++k)  // constant indices: le stays in registers
                    if (k < p.n_le) le[k] = le[k] + p.loss_e[(int64_t)k * p.M + e];
            }
        }
        // l_dist's cross terms with the entries before this one
        const float W_inc = warp_prefix<G>(W, lg), WT_inc = warp_prefix<G>(WT, lg);
        const float A_inc = warp_prefix<G>(A, lg), AT_inc = warp_prefix<G>(AT, lg);
        const float Wp = W_c + warp_exclusive<G>(W_inc, lg);
        const float WTp = WT_c + warp_exclusive<G>(WT_inc, lg);
        const float Ap = A_c + warp_exclusive<G>(A_inc, lg);
        const float ATp = AT_c + warp_exclusive<G>(AT_inc, lg);
        l_dist = l_dist + (Wp * WT - WTp * W);
        l_dist_a = l_dist_a + (Ap * AT - ATp * A);
        W_c = W_c + warp_total<G>(W_inc);
        WT_c = WT_c + warp_total<G>(WT_inc);
        A_c = A_c + warp_total<G>(A_inc);
        AT_c = AT_c + warp_total<G>(AT_inc);
    }

    // the median: the smallest live t where the running weight reaches
    // half the total, over the live entries' weights as written above
    totW = warp_allsum<G>(totW);
    float t_med = INFINITY;
    {
        const float thr = 0.5f * totW;
        const int64_t e_end = totW > 1e-12f ? e_dead : e0;
        float preW_c = 0.0f;
        for (int64_t base = e0; __any_sync(kFullWarp, base < e_end); base += G) {
            const int64_t e = base + lg;
            const bool valid = e < e_end;
            float ws = 0.0f;
            if (valid)
                for (int s = 0; s < p.S0; ++s) ws = ws + p.weight[(int64_t)s * p.M + e];
            const float inc = warp_prefix<G>(ws, lg);
            float pw = preW_c + warp_exclusive<G>(inc, lg);
            if (valid) {
                for (int s = 0; s < p.S0; ++s) {
                    const int64_t i = (int64_t)s * p.M + e;
                    const float w = p.weight[i];
                    if (p.contrib[i] && pw + w >= thr) t_med = fminf(t_med, p.t[i]);
                    pw = pw + w;
                }
            }
            preW_c = preW_c + warp_total<G>(inc);
        }
        t_med = warp_allmin<G>(t_med);
    }

    // K11c: the cache's median over its cached weights, and zeros past them
    if (p.cache_K > 0) {
        const int n_cached = min(ncache_c, p.cache_K);
        __syncwarp();  // the rows other lanes of the group wrote
        float tot = 0.0f;
        for (int k0 = 0; k0 < p.cache_K; k0 += G) {
            const int k = k0 + lg;
            tot = tot + warp_allsum<G>(k < n_cached ? p.c_w[cbase + k] : 0.0f);
        }
        const float thr = fmaxf(0.5f * tot, 1e-12f);
        float cum = 0.0f;
        int hit = -1;
        for (int k0 = 0; k0 < p.cache_K; k0 += G) {
            const int k = k0 + lg;
            const bool in = k < n_cached;
            const float inc = warp_prefix<G>(in ? p.c_w[cbase + k] : 0.0f, lg);
            const unsigned h = segment_bits<G>(__ballot_sync(kFullWarp, in && cum + inc >= thr),
                                               lane);
            if (hit < 0 && h) hit = k0 + __ffs(h) - 1;
            cum = cum + warp_total<G>(inc);
        }
        if (has_ray && lg == 0) {
            p.cache_med[r] = tot > 0.0f && hit >= 0 ? p.c_ts[cbase + hit] : 0.0f;
            p.n_cached[r] = n_cached;
        }
        __syncwarp();  // the median's read before the zeros
        if (has_ray) {
            for (int k = n_cached + lg; k < p.cache_K; k += G) {
                p.c_ts[cbase + k] = 0.0f;
                p.c_alpha[cbase + k] = 0.0f;
                p.c_w[cbase + k] = 0.0f;
                p.c_fake[cbase + k] = false;
            }
        }
    }

    // the ray's sums over its lanes
    for (int k = 0; k < 3; ++k) {
        rgb[k] = warp_allsum<G>(rgb[k]);
        nrm[k] = warp_allsum<G>(nrm[k]);
    }
    depth = warp_allsum<G>(depth);
    l_dist = warp_allsum<G>(l_dist);
    l_dist_a = warp_allsum<G>(l_dist_a);
    ent = warp_allsum<G>(ent);
    ent_a = warp_allsum<G>(ent_a);
    sp_logsig = warp_allsum<G>(sp_logsig);
    sp_logsig_w = warp_allsum<G>(sp_logsig_w);
    sp_w = warp_allsum<G>(sp_w);
    for (int k = 0; k < 5; ++k) le[k] = warp_allsum<G>(le[k]);
    cnt_win = warp_allsum<G>(cnt_win);
    t_sig = warp_allmin<G>(t_sig);
    // the mode: the larger weight; on a tie the larger t (the packed
    // renderer's rule) or the earlier entry (the walks' first maximum)
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
        const float w2 = __shfl_xor_sync(kFullWarp, wm, d, G);
        const float t2 = __shfl_xor_sync(kFullWarp, tm, d, G);
        const int e2 = __shfl_xor_sync(kFullWarp, em, d, G);
        if (p.mode_first) {
            if (w2 > wm || (w2 == wm && e2 < em)) {
                wm = w2;
                tm = t2;
                em = e2;
            }
        } else if (w2 > wm) {
            wm = w2;
            tm = t2;
        } else if (w2 == wm) {
            tm = fmaxf(tm, t2);
        }
    }
    if (!has_ray || lg != 0) return;
    const float T = expf(pre_c);
    for (int k = 0; k < 3; ++k) {
        const float bg = p.bg_rgb ? p.bg_rgb[3 * (int64_t)r + k] : p.bg;
        p.out_rgb[3 * (int64_t)r + k] = rgb[k] + T * bg;
        p.normal[3 * (int64_t)r + k] = nrm[k];
    }
    p.depth[r] = depth;
    p.log_T[r] = pre_c;
    p.depth_mode[r] = finite(tm) ? tm : 0.0f;
    p.depth_med[r] = finite(t_med) ? t_med : 0.0f;
    p.n_int[r] = cnt_win;
    if (p.sig_on) p.depth_sig[r] = finite(t_sig) ? t_sig : 0.0f;
    const float losses[12] = {l_dist, l_dist_a, ent, ent_a, sp_logsig, sp_logsig_w, sp_w,
                              le[0], le[1], le[2], le[3], le[4]};
    for (int k = 0; k < 12; ++k) p.losses[(int64_t)k * p.B + r] = losses[k];
}

extern "C" cudaError_t composite(const int64_t* offsets, int B, long long M, int S0,
                                 const float* t, const float* alpha, const bool* contrib,
                                 const bool* fake, const int* counted, const float* rgb,
                                 const float* snorm, const float* loss_e, int n_le, int truncated,
                                 const float* trunc_a, float trunc_wmin, int stop_on, float log_stop,
                                 float bg, const float* bg_rgb, int fake_l_dist,
                                 float* out_rgb, float* depth,
                                 float* normal, float* log_T, float* depth_mode, float* depth_med,
                                 int* n_int, float* losses, float* weight, int sig_on,
                                 float sig_thresh, float* depth_sig, bool* live, int window,
                                 int mode_first, int cache_K, float* c_ts, float* c_alpha,
                                 float* c_w, bool* c_fake, int* n_cached, float* cache_med,
                                 bool* win, float* live_alpha, void* stream) {
    if (B <= 0) return cudaSuccess;
    const CompositeParams p{offsets, B, M, S0, t, alpha, contrib, fake, counted, rgb, snorm,
                            loss_e, n_le, truncated, trunc_a, trunc_wmin, stop_on, log_stop, bg,
                            bg_rgb, fake_l_dist, out_rgb, depth, normal, log_T, depth_mode, depth_med,
                            n_int, losses, weight, sig_on, sig_thresh, depth_sig, live, window,
                            mode_first, cache_K, c_ts, c_alpha, c_w, c_fake, n_cached, cache_med,
                            win, live_alpha};
    constexpr int G = kK4Lanes;
    const cudaStream_t s = (cudaStream_t)stream;
    if (M == 0) {  // no entries: a lane a ray writes the background
        composite_kernel<1><<<(B + kK4Block - 1) / kK4Block, kK4Block, 0, s>>>(p);
    } else {
        const int64_t threads = (int64_t)B * G;
        composite_kernel<G><<<(unsigned)((threads + kK4Block - 1) / kK4Block), kK4Block, 0, s>>>(p);
    }
    return cudaGetLastError();
}
#endif

// the world point of slot s of pool entry e, written at e * S0 + s
HD void intersect_point(const int* ray_id, const float* t, const float* origins,
                        const float* dirs, int S0, int64_t M, const float* rscaling,
                        const float* roffset, int64_t i, float* pts) {
    const int64_t e = i / S0, s = i % S0;
    const int64_t r = ray_id[e];
    const float ts = t[s * M + e];
    for (int a = 0; a < 3; ++a) {
        const float g = origins[3 * r + a] + ts * dirs[3 * r + a];
        pts[3 * i + a] = g * rscaling[a] + roffset[a];
    }
}

#ifdef __CUDACC__
__global__ void intersect_points_kernel(const int* ray_id, const float* t, const float* origins,
                                        const float* dirs, int S0, int64_t M, float rs0, float rs1,
                                        float rs2, float ro0, float ro1, float ro2, float* pts) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M * S0) return;
    const float rscaling[3] = {rs0, rs1, rs2}, roffset[3] = {ro0, ro1, ro2};
    intersect_point(ray_id, t, origins, dirs, S0, M, rscaling, roffset, i, pts);
}

extern "C" cudaError_t intersect_points(const int* ray_id, const float* t, const float* origins,
                                        const float* dirs, int S0, long long M, float rs0,
                                        float rs1, float rs2, float ro0, float ro1, float ro2,
                                        float* pts, void* stream) {
    const long long n = M * S0;
    if (n <= 0) return cudaSuccess;
    const int block = 256;
    intersect_points_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                              (cudaStream_t)stream>>>(ray_id, t, origins, dirs, S0, M, rs0, rs1,
                                                      rs2, ro0, ro1, ro2, pts);
    return cudaGetLastError();
}
#endif
