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
// 40 bytes) and its weight written once; per ray ~100 bytes out. Design:
// one thread per ray walks its pool range [offsets[r], offsets[r+1]).
// Every per-ray prefix is a running sum in registers: the JAX version's
// global cumsum minus a per-ray base cancels badly in float32, this does
// not. The median needs the ray's total weight first, so a second pass
// re-reads the ray's own weights.
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

HD void composite_ray(const CompositeParams& p, int r) {
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    const float ta = p.trunc_a[0];
    int cnt = 0;
    int64_t e_dead = e1;  // entries from here on were killed by stop_thresh
    float entry_pre = 0.0f, pre_att = 0.0f, totW = 0.0f;
    float rgb[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f}, depth = 0.0f;
    float wmax = 0.0f, t_mode = -INFINITY;
    float preA = 0.0f, preS = 0.0f, preAw = 0.0f, preSw = 0.0f;
    float l_dist = 0.0f, l_dist_a = 0.0f, ent = 0.0f, ent_a = 0.0f;
    float sp_logsig = 0.0f, sp_logsig_w = 0.0f, sp_w = 0.0f;
    float inward = 0.0f, lap = 0.0f, lap_cnt = 0.0f, udf_sum = 0.0f, udf_cnt = 0.0f;
    float t_sig = INFINITY;
    int cnt_win = 0, ncache = 0;
    bool chunk_live = true;
    const int64_t cbase = (int64_t)r * p.cache_K;

    for (int64_t e = e0; e < e1; ++e) {
        bool alive = true;
        if (p.stop_on) {
            // the entry lives while the transmittance at its entry, taken
            // over the un-killed samples, is above stop_thresh
            float la = 0.0f;
            int c = cnt;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                if (p.contrib[i]) la = la + logf(one_minus(alpha_trunc(p, i, c, ta)));
                c += p.counted[i];
            }
            alive = entry_pre > p.log_stop;
            entry_pre = entry_pre + la;
        }
        if (!alive && e_dead == e1) e_dead = e;
        if (p.window > 0 && (e - e0) % p.window == 0) chunk_live = e == e0 || alive;
        const bool in_win = p.window <= 0 || chunk_live;
        if (p.win) p.win[e] = in_win;

        float w_best = -1.0f, t_best = 0.0f;
        for (int s = 0; s < p.S0; ++s) {
            const int64_t i = (int64_t)s * p.M + e;
            const float at = alpha_trunc(p, i, cnt, ta);
            cnt += p.counted[i];
            if (in_win) cnt_win += p.counted[i];
            const bool c = p.contrib[i] && alive;
            const float ac = c ? at : 0.0f;
            const float om = c ? one_minus(ac) : 1.0f;
            const float w = c ? expf(fminf(pre_att, 0.0f)) * (1.0f - om) : 0.0f;
            pre_att = pre_att + logf(om);
            p.weight[i] = w;
            if (p.live) p.live[i] = c;
            if (p.live_alpha) p.live_alpha[i] = ac;
            totW = totW + w;
            const float t = p.t[i];
            if (p.sig_on && c && !p.fake[i] && p.alpha[i] > p.sig_thresh) t_sig = fminf(t_sig, t);
            for (int k = 0; k < 3; ++k) {
                rgb[k] = rgb[k] + w * p.rgb[((int64_t)k * p.S0 + s) * p.M + e];
                nrm[k] = nrm[k] + w * p.snorm[((int64_t)k * p.S0 + s) * p.M + e];
            }
            depth = depth + w * t;
            if (w > w_best) {  // the entry's first max-weight slot
                w_best = w;
                t_best = t;
            }
            if (p.mode_first && w > wmax) {  // the ray's first max-weight sample
                wmax = w;
                t_mode = t;
            }
            if (c && ncache < p.cache_K) {
                p.c_ts[cbase + ncache] = t;
                p.c_alpha[cbase + ncache] = ac;
                p.c_w[cbase + ncache] = w;
                p.c_fake[cbase + ncache] = p.fake[i];
                ++ncache;
            }
            const bool inc = c && (p.fake_l_dist || !p.fake[i]);
            const float ai = inc ? ac : 0.0f;
            const float wi = inc ? w : 0.0f;
            l_dist_a = l_dist_a + ai * (t * preA - preS);
            preA = preA + ai;
            preS = preS + ai * t;
            l_dist = l_dist + wi * (t * preAw - preSw);
            preAw = preAw + wi;
            preSw = preSw + wi * t;
            if (wi > 0.0f) ent = ent + -wi * logf(fmaxf(wi, 1e-8f));
            if (ai > 0.0f) ent_a = ent_a + -ai * logf(fmaxf(ai, 1e-8f));
            if (c) {
                const float logsig = logf(fmaxf(-logf(fmaxf(1.0f - ac, 1e-8f)), 1e-8f));
                sp_logsig = sp_logsig + logsig;
                sp_logsig_w = sp_logsig_w + logsig * w;
                sp_w = sp_w + w;
            }
        }
        if (p.mode_first) {
        } else if (w_best > wmax) {
            wmax = w_best;
            t_mode = t_best;
        } else if (w_best == wmax && w_best > 0.0f) {
            t_mode = fmaxf(t_mode, t_best);
        }
        if (in_win) {
            inward = inward + p.loss_e[e];
            lap = lap + p.loss_e[p.M + e];
            lap_cnt = lap_cnt + p.loss_e[2 * p.M + e];
            if (p.n_le == 5) {
                udf_sum = udf_sum + p.loss_e[3 * p.M + e];
                udf_cnt = udf_cnt + p.loss_e[4 * p.M + e];
            }
        }
    }

    if (p.cache_K > 0) {
        float tot = 0.0f;
        for (int k = 0; k < ncache; ++k) tot = tot + p.c_w[cbase + k];
        const float thr = fmaxf(0.5f * tot, 1e-12f);
        float cum = 0.0f, med = 0.0f;
        for (int k = 0; k < ncache; ++k) {
            cum = cum + p.c_w[cbase + k];
            if (cum >= thr) {
                med = p.c_ts[cbase + k];
                break;
            }
        }
        p.cache_med[r] = tot > 0.0f ? med : 0.0f;
        p.n_cached[r] = ncache;
        for (int k = ncache; k < p.cache_K; ++k) {
            p.c_ts[cbase + k] = 0.0f;
            p.c_alpha[cbase + k] = 0.0f;
            p.c_w[cbase + k] = 0.0f;
            p.c_fake[cbase + k] = false;
        }
    }

    float t_med = INFINITY;
    if (totW > 1e-12f) {
        float preW = 0.0f;
        for (int64_t e = e0; e < e_dead; ++e) {
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                const float w = p.weight[i];
                if (p.contrib[i] && preW + w >= 0.5f * totW) t_med = fminf(t_med, p.t[i]);
                preW = preW + w;
            }
        }
    }

    const float T = expf(pre_att);
    for (int k = 0; k < 3; ++k) {
        const float bg = p.bg_rgb ? p.bg_rgb[3 * (int64_t)r + k] : p.bg;
        p.out_rgb[3 * (int64_t)r + k] = rgb[k] + T * bg;
        p.normal[3 * (int64_t)r + k] = nrm[k];
    }
    p.depth[r] = depth;
    p.log_T[r] = pre_att;
    p.depth_mode[r] = finite(t_mode) ? t_mode : 0.0f;
    p.depth_med[r] = finite(t_med) ? t_med : 0.0f;
    p.n_int[r] = cnt_win;
    if (p.sig_on) p.depth_sig[r] = finite(t_sig) ? t_sig : 0.0f;
    const float losses[12] = {l_dist, l_dist_a, ent, ent_a, sp_logsig, sp_logsig_w, sp_w,
                              inward, lap, lap_cnt, udf_sum, udf_cnt};
    for (int k = 0; k < 12; ++k) p.losses[(int64_t)k * p.B + r] = losses[k];
}

#ifdef __CUDACC__
__global__ void composite_kernel(CompositeParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) composite_ray(p, r);
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
    const int block = 128;
    composite_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(p);
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
