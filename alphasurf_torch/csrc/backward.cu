// K5: the backward of the packed surface renderer (K2-K4), in two passes
// over what the forward saved.
//
// Replaces jax.grad of the JAX package's render/surface.py:
// volume_render_surface_packed (1737-2015) with the root JVP of
// ops/cubic.py:_cubic_roots_T_jvp (230-242). The rgb-only instantiations
// take the cotangents of rgb (B, 3) and ray_losses (12, B); the second ones
// those of every other output too (chosen by the entries' last pointer,
// below: K5a's output cotangents, K5b's d_snorm; the wrappers count them as
// backward_ray_out and backward_entry_out).
//
// K5a, backward_ray: one thread per ray. Pass 1 walks the ray's slots in
// (entry, slot) order (truncation by running intersection index, the
// stop_thresh kill of whole entries, transmittance), the log transmittance
// at each entry by K4's scan over its groups of kK4Lanes entries
// (common.cuh's serial_prefix: K4's additions in K4's order), so the kill
// and the weights have K4's bits, and parks in the output arrays what pass
// 2 needs: the slot's truncated
// alpha (-1 where it does not contribute), its transmittance, and the
// prefix parts of the l_dist(_a) derivatives. Pass 2 walks back and turns
// them into per-slot cotangents of the pre-truncation alpha, of t and of
// the three clipped colours. The suffix sum Sigma carries d loss / d
// log(1 - alpha) of every later slot plus the background term; the
// l_dist(_a) pairs split into a prefix part (pass 1) and a suffix part
// (pass 2), so every sum is a running sum and none is a difference of
// totals.
//
// K5b, backward_entry: one thread per pool entry, like K3. It recomputes
// the entry's samples with the very code of K3 (samples.cuh) and chains
// the slot cotangents, plus the inward-norm and density-lap terms of
// ray_losses, into the 8 corner rows: density through the trilinear
// weights; SH through the weights times the SH basis where the colour was
// not clipped; surface through the root (implicit differentiation:
// dt/df_i = -t^i / f'(t), |f'| kept >= 1e-10) and the cubic's
// coefficients, through the sample position into the weights, and through
// the fake sample's normalised surface value and the std of the 8 corners;
// fake_sample_std through the Gaussian reweight. Rows are scattered with
// atomicAdd; the fake_sample_std gradient is summed over the warp first,
// since every entry of the pool adds to that one address.
//
// The surface types' branches of K5b follow K3's: the UDF types multiply
// the corner-value cotangents by softplus's derivative and add the udf-var
// term's (ray loss 10); PLANE's root carries its cotangent into the mean
// plane (the clip of d taken as jnp.clip, max then min, half at a tie) and
// an eighth of that into each corner's 4 surface channels; VOXEL_FACE's
// alpha into corner 0's density through the sigmoid. UDF_ALPHA's slots
// read their alpha from the (n_lv,) table: every entry of the pool adds to
// one of its few rows, so each thread keeps its sums of the first
// MAX_LV_TABLE level sets and each warp adds them with one atomic a row;
// a level set past those adds its own atomics (a grid's many level sets
// are nested shells, each crossed by few of a warp's entries).
//
// K11d, the gradient through the first-K sample cache (K11c): the
// cotangents of the cached ts, alphas and weights, (B, cache_K) each, join
// K5a's per-slot cotangents. Pass 2 of backward_ray recounts a slot's cache
// column from the ray's number of contributing slots (K4 filled columns in
// walk order), adds the weight's cotangent to the slot's weight cotangent
// (then the suffix rule carries it to every earlier alpha), the alpha's to
// the truncated alpha's, and the t's to d_t, which K5b takes through the
// cubic root's JVP. backward_entry skips the inward/lap terms of entries
// outside K4's count window (win). Bound: bytes, 12 more a cached sample.
//
// The learned bases (a 3D texture or an MLP of the view direction) train
// through the per-ray basis sh_mult (B, bd): with a g_sh_mult output, K5b
// also gives g_sh_mult[r, b] = sum_c sum_ch dC[ch][c] * row_c[ch bd + b],
// the same colour cotangents dC that scatter into the SH rows, contracted
// with the corner rows instead of the basis. A ray's pool entries are
// contiguous, so each warp sums them per ray with a segmented shuffle
// (lanes of one ray add their neighbours' values over offsets 1..16) and
// the first lane of each ray in the warp issues bd atomics, where one per
// entry would pile bd atomics a entry onto the same slots. The kernel is
// templated on the output: without it (a null pointer) the code and the
// other outputs are today's.
//
// The outputs' cotangents, K5a's second instantiation (kOut): depth (d w +=
// g t, d t += g w), normal (d w += g . n; d_snorm = g w, 3 floats a slot for
// K5b), log_T (joins the suffix sum Sigma of every slot's log(1 - alpha)),
// the intersections' points (into d t through the ray's direction and
// grid2world's scale, on every slot), pre-truncation alphas (into d_alpha)
// and weights, and the samples' t, weights and truncated alphas. The depths
// that pick one sample take K4's rules on K4's float32 weights: pass 1
// re-walks the mode (the packed rule: the largest t among the entries whose
// first max-weight slot holds the ray's max; the walks' rule: the first
// max-weight slot) and the sigma-thresh depth (the smallest t of a real
// slot above the threshold), which do not depend on the order; a pass 1b
// finds the median's hits and the cache median's column with K4's sums in
// K4's order (its lanes' totals, its scans over each group), so each picks
// K4's sample. Ties split the cotangent evenly, as jax.grad of a min or max
// does. K5b's second
// instantiation (kNormal) carries d_snorm through the unit normal's Jacobian
// ((I - n n^T) / -|g| above the 1e-20 floor, 1 / -1e-10 below it) into the
// field's gradient: each corner value's direct term and, through the
// trilinear weights' mixed second derivatives, the sample position, whose
// cotangent then joins the root's JVP (PLANE: into the mean plane's a, b,
// c). Both are template parameters: the rgb-only code is unchanged.
//
// Bound: K5a by bytes (each slot's t, alpha, colour and flags read, its
// cotangents written: about 40 bytes a slot), K5b by the random 8-row
// gathers and the atomics into the rows (each entry reads 8 rows of 32
// floats and adds to 8 x 29). Design: one thread per ray and one per entry,
// no shared memory; nothing is sorted. Clamps and maxima take JAX's
// derivative at an exact tie (half the gradient), so the kernel and the
// plain version (autograd of the plain renderer) agree on ties in float32.
#include "samples.cuh"

// the level sets whose UDF_ALPHA table cotangents K5b sums per warp
constexpr int MAX_LV_TABLE = 64;

// ---------------------------------------------------------------------------
// K5a
// ---------------------------------------------------------------------------

struct BackRayParams {
    const int64_t* offsets;
    int B;
    int64_t M;
    int S0;
    const float* t;
    const float* alpha;
    const bool* contrib;
    const bool* fake;
    const int* counted;
    const float* rgb;  // (3, S0, M), clipped colours
    int truncated;
    const float* trunc_a;
    float trunc_wmin;
    int stop_on;
    float log_stop;
    float bg;
    const float* bg_rgb;  // (B, 3) per-ray background colour (K13), or null: bg
    int fake_l_dist;
    const float* g_rgb;  // (B, 3)
    const float* g_rl;   // (12, B)
    float* d_alpha;      // (S0, M), cotangent of the pre-truncation alpha
    float* d_t;          // (S0, M)
    float* d_col;        // (3, S0, M), cotangent of the clipped colour
    int cache_K;
    const float* g_cts;     // (B, cache_K) or null
    const float* g_calpha;
    const float* g_cw;
};

// The output cotangents of K5a's second instantiation, each null when
// absent (kernels.py's _BackRayOut has this layout).
struct BackRayOut {
    const float* snorm;  // (3, S0, M), K3's rendered normal
    const float* dirs;   // (B, 3) grid-space ray directions
    int mode_first;      // the walks' first-max mode depth, else the packed rule
    float sig_thresh;
    float rscale[3];        // grid2world's per-axis scale
    const float* g_depth;   // (B,)
    const float* g_normal;  // (B, 3)
    const float* g_log_T;   // (B,)
    const float* g_mode;    // (B,)
    const float* g_med;     // (B,) the cache-free median (the packed renderer's)
    const float* g_cmed;    // (B,) the cache's median (the dense and compact renderers')
    const float* g_sig;     // (B,) the sigma-thresh depth
    const float* g_pts;     // (M S0, 3) the intersections' points, entry-major
    const float* g_st;      // (S0, M) the slot's t
    const float* g_sa;      // (S0, M) its pre-truncation alpha
    const float* g_sw;      // (S0, M) its weight
    const float* g_sac;     // (S0, M) its truncated alpha where it contributes
    float* d_snorm;         // (3, S0, M) the normal's cotangent, for K5b; with g_normal
};

// d/dx of -x log(max(x, 1e-8)) for x > 0
HD float entropy_grad(float x) {
    const float cx = fmaxf(x, 1e-8f);
    return -logf(cx) - x * clip_lo_grad(x, 1e-8f) / cx;
}

// d/da of log(max(-log(max(1 - a, 1e-8)), 1e-8)) (sp_logsig)
HD float logsig_grad(float a) {
    const float om = 1.0f - a;
    const float u = fmaxf(om, 1e-8f);
    const float v = -logf(u);
    return clip_lo_grad(v, 1e-8f) / fmaxf(v, 1e-8f) / u * clip_lo_grad(om, 1e-8f);
}

HD float alpha_trunc(const BackRayParams& p, int64_t i, int cnt, float ta) {
    const float a = p.alpha[i];
    return p.truncated ? a * trunc_rw(cnt - (p.fake[i] ? 1 : 0), ta, p.trunc_wmin) : a;
}

// What K5a's second instantiation finds in its forward passes: the samples that the
// mode, median and sigma-thresh depths take (K4's rules on K4's float32
// weights, its sums in its order), with their tie counts: jax.grad of a min
// or a max splits the cotangent evenly over tied elements.
struct Picks {
    float lane_w[kK4Lanes];  // K4's lanes' weight sums, whose total sets the median's threshold
    float wmax, t_mode;   // the mode: packed rule (is_best entries, largest t)
    int n_mode;
    int64_t i_mode;       // the walks' rule: the first max-weight slot
    float thr;            // the cache-free median: half the total weight,
    float t_med;          // the smallest t of a hit,
    int n_med;            // the hits at that t
    int64_t i_med;        // and the first of them
    int k_med;            // the cache median's column, -1: none
    float t_sig;
    int n_sig;
};

// the ray's slot weight as K4 computes it, from what pass 1 parked: the
// truncated alpha (< 0: not contributing) and the transmittance
HD float parked_weight(const BackRayParams& p, int64_t i) {
    const float at = p.d_alpha[i];
    if (at < 0.0f) return 0.0f;
    return p.d_col[2 * (int64_t)p.S0 * p.M + i] * (1.0f - one_minus(at));
}

// the first max-weight slot of entry e (K4's w_best), by pass 1's parking
HD int entry_best(const BackRayParams& p, int64_t e, float& w_best) {
    int s_best = 0;
    w_best = -1.0f;
    for (int s = 0; s < p.S0; ++s) {
        const float w = parked_weight(p, (int64_t)s * p.M + e);
        if (w > w_best) {
            w_best = w;
            s_best = s;
        }
    }
    return s_best;
}

// K4's median test over the ray's contributing slots in walk order:
// visit(i, hit) for each, hit when the running weight before the slot by
// K4's sums (the entries' weight sums scanned over each group of kK4Lanes
// entries, then serial within an entry) plus its own weight reaches thr;
// visit returns false to stop. A slot's test depends only on the slots
// before it.
template <class Visit>
HD void median_scan(const BackRayParams& p, int64_t e0, int64_t e1, float thr, Visit visit) {
    constexpr int G = kK4Lanes;
    float preW_c = 0.0f;
    for (int64_t base = e0; base < e1; base += G) {
        float ws[G];
        for (int j = 0; j < G; ++j) {
            ws[j] = 0.0f;
            if (base + j < e1)
                for (int s = 0; s < p.S0; ++s)
                    ws[j] = ws[j] + parked_weight(p, (int64_t)s * p.M + base + j);
        }
        serial_prefix<G>(ws);
        for (int j = 0; j < G && base + j < e1; ++j) {
            float pw = preW_c + (j > 0 ? ws[j - 1] : 0.0f);
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + base + j;
                const float w = parked_weight(p, i);
                if (p.d_alpha[i] >= 0.0f && !visit(i, pw + w >= thr)) return;
                pw = pw + w;
            }
        }
        preW_c = preW_c + ws[G - 1];
    }
}

// K4's cached weights (the ray's first cache_K contributing slots') in its
// groups of kK4Lanes columns: f(w, k0, n) for each, w the group's weights
// (zeros past the n cached), k0 its first column
template <class F>
HD void cache_groups(const BackRayParams& p, int64_t e0, int64_t e1, F f) {
    constexpr int G = kK4Lanes;
    float w[G];
    int n = 0, k0 = 0;
    for (int64_t e = e0; e < e1 && k0 + n < p.cache_K; ++e) {
        for (int s = 0; s < p.S0 && k0 + n < p.cache_K; ++s) {
            const int64_t i = (int64_t)s * p.M + e;
            if (p.d_alpha[i] < 0.0f) continue;
            w[n++] = parked_weight(p, i);
            if (n == G) {
                f(w, k0, n);
                k0 += G;
                n = 0;
            }
        }
    }
    if (n > 0) {
        for (int j = n; j < G; ++j) w[j] = 0.0f;
        f(w, k0, n);
    }
}

// pass 1b: the median picks, once the totals are known, by K4's sums in
// K4's order: the same bits, so the same samples
HD void find_medians(const BackRayParams& p, const BackRayOut& q, int64_t e0, int64_t e1,
                     Picks& k) {
    constexpr int G = kK4Lanes;
    k.t_med = INFINITY;
    k.n_med = 0;
    k.i_med = -1;
    k.k_med = -1;
    const float totW = serial_allsum<G>(k.lane_w);
    k.thr = 0.5f * totW;
    if (q.g_med && totW > 1e-12f) {
        median_scan(p, e0, e1, k.thr, [&](int64_t i, bool hit) {
            const float t = p.t[i];
            if (hit && t < k.t_med) {
                k.t_med = t;
                k.n_med = 1;
                k.i_med = i;
            } else if (hit && t == k.t_med) {
                ++k.n_med;
            }
            return true;
        });
    }
    if (q.g_cmed && p.cache_K > 0) {
        float tot = 0.0f;
        cache_groups(p, e0, e1, [&](float* w, int, int) { tot = tot + serial_allsum<G>(w); });
        if (tot > 0.0f) {
            const float thr = fmaxf(0.5f * tot, 1e-12f);
            float cum = 0.0f;
            cache_groups(p, e0, e1, [&](float* w, int k0, int n) {
                serial_prefix<G>(w);
                for (int j = 0; j < n && k.k_med < 0; ++j)
                    if (cum + w[j] >= thr) k.k_med = k0 + j;
                cum = cum + w[G - 1];
            });
        }
    }
}

// whether slot i is a hit of K4's median test (pass 2's ties: slots before
// i are as pass 1 parked them)
HD bool median_hit(const BackRayParams& p, int64_t e0, int64_t e1, float thr, int64_t i) {
    bool out = false;
    median_scan(p, e0, e1, thr, [&](int64_t j, bool hit) {
        if (j != i) return true;
        out = hit;
        return false;
    });
    return out;
}

template <bool kOut>
HD void backward_ray_thread(const BackRayParams& p, const BackRayOut& q, int r) {
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    const int64_t SM = (int64_t)p.S0 * p.M;
    const float ta = p.trunc_a[0];
    const float g_ld = p.g_rl[r], g_lda = p.g_rl[p.B + r];
    const float g_ent = p.g_rl[2 * p.B + r], g_enta = p.g_rl[3 * p.B + r];
    const float g_sls = p.g_rl[4 * p.B + r], g_slsw = p.g_rl[5 * p.B + r];
    const float Gc[3] = {p.g_rgb[3 * (int64_t)r], p.g_rgb[3 * (int64_t)r + 1],
                        p.g_rgb[3 * (int64_t)r + 2]};
    Picks k;
    if constexpr (kOut) {
        for (int j = 0; j < kK4Lanes; ++j) k.lane_w[j] = 0.0f;
        k.wmax = 0.0f;
        k.t_mode = -INFINITY;
        k.n_mode = 0;
        k.i_mode = -1;
        k.t_sig = INFINITY;
        k.n_sig = 0;
    }

    // pass 1: forward, as K4 computes it, in its groups of G entries: each
    // entry's log transmittance at its start by K4's scan over the group,
    // so that the stop_thresh kill, the weights and log_T keep K4's bits,
    // and with them every pick
    constexpr int G = kK4Lanes;
    int cnt = 0, n_contrib = 0;
    int64_t e_dead = e1;  // entries from here on were killed by stop_thresh
    float pre_c = 0.0f;   // the log transmittance before the group (K4's log_T at the end)
    float Aw = 0.0f, Sw = 0.0f, Aa = 0.0f, Sa = 0.0f;
    for (int64_t base = e0; base < e1; base += G) {
        // the entries' log attenuations while the ray lives, scanned
        float la[G];
        int c = cnt;
        for (int j = 0; j < G; ++j) {
            la[j] = 0.0f;
            if (base + j >= e1) continue;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + base + j;
                if (base + j < e_dead && p.contrib[i])
                    la[j] = la[j] + logf(one_minus(alpha_trunc(p, i, c, ta)));
                c += p.counted[i];
            }
        }
        serial_prefix<G>(la);
        const float pre_g = pre_c;
        int k_dead = -1;  // the group's first entry the kill takes
        for (int j = 0; p.stop_on && j < G && k_dead < 0; ++j)
            if (base + j < e1 && base + j < e_dead &&
                !(pre_g + (j > 0 ? la[j - 1] : 0.0f) > p.log_stop))
                k_dead = j;
        if (k_dead >= 0) {
            e_dead = base + k_dead;
            pre_c = pre_g + (k_dead > 0 ? la[k_dead - 1] : 0.0f);
        } else {
            pre_c = pre_g + la[G - 1];
        }
        for (int j = 0; j < G && base + j < e1; ++j) {
            const int64_t e = base + j;
            const bool alive = e < e_dead;
            const float e_pre = pre_g + (j > 0 ? la[j - 1] : 0.0f);
            float local = 0.0f;  // the log attenuation of the entry's slots so far
            float w_best = -1.0f, t_best = 0.0f;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                const float at = alpha_trunc(p, i, cnt, ta);
                cnt += p.counted[i];
                if (!(p.contrib[i] && alive)) {
                    p.d_alpha[i] = -1.0f;  // not contributing
                    if constexpr (kOut) {
                        if (0.0f > w_best) {
                            w_best = 0.0f;
                            t_best = p.t[i];
                        }
                    }
                    continue;
                }
                ++n_contrib;
                const float om = one_minus(at);
                const float T = expf(fminf(e_pre + local, 0.0f));
                local = local + logf(om);
                const bool inc = p.fake_l_dist || !p.fake[i];
                const float w = T * (1.0f - om);
                const float wi = inc ? w : 0.0f, a = inc ? at : 0.0f;
                const float t = p.t[i];
                p.d_alpha[i] = at;
                p.d_t[i] = g_ld * wi * Aw + g_lda * a * Aa;
                p.d_col[i] = g_ld * (t * Aw - Sw);
                p.d_col[SM + i] = g_lda * (t * Aa - Sa);
                p.d_col[2 * SM + i] = T;
                Aw = Aw + wi;
                Sw = Sw + wi * t;
                Aa = Aa + a;
                Sa = Sa + a * t;
                if constexpr (kOut) {
                    k.lane_w[j] = k.lane_w[j] + w;
                    if (w > w_best) {
                        w_best = w;
                        t_best = t;
                    }
                    if (q.mode_first && w > k.wmax) {
                        k.wmax = w;
                        k.i_mode = i;
                    }
                    if (!p.fake[i] && p.alpha[i] > q.sig_thresh) {
                        if (t < k.t_sig) {
                            k.t_sig = t;
                            k.n_sig = 1;
                        } else if (t == k.t_sig) {
                            ++k.n_sig;
                        }
                    }
                }
            }
            if constexpr (kOut) {
                if (q.mode_first) {
                } else if (w_best > k.wmax) {
                    k.wmax = w_best;
                    k.t_mode = t_best;
                    k.n_mode = 1;
                } else if (w_best == k.wmax && w_best > 0.0f) {
                    if (t_best > k.t_mode) {
                        k.t_mode = t_best;
                        k.n_mode = 1;
                    } else if (t_best == k.t_mode) {
                        ++k.n_mode;
                    }
                }
            }
        }
    }

    // the per-ray output cotangents
    float gd = 0.0f, gn[3] = {0.0f, 0.0f, 0.0f}, g_mode = 0.0f, g_sig = 0.0f, g_med = 0.0f;
    float g_cmed = 0.0f;
    float dir[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kOut) {
        find_medians(p, q, e0, e1, k);
        if (q.g_depth) gd = q.g_depth[r];
        if (q.g_normal)
            for (int c = 0; c < 3; ++c) gn[c] = q.g_normal[3 * (int64_t)r + c];
        if (q.g_mode && k.wmax > 0.0f) g_mode = q.g_mode[r] / (q.mode_first ? 1 : k.n_mode);
        if (q.g_med && k.n_med > 0) g_med = q.g_med[r] / k.n_med;
        if (q.g_sig && k.n_sig > 0) g_sig = q.g_sig[r] / k.n_sig;
        if (q.g_cmed && k.k_med >= 0) g_cmed = q.g_cmed[r];
        if (q.g_pts)
            for (int c = 0; c < 3; ++c) dir[c] = q.dirs[3 * (int64_t)r + c] * q.rscale[c];
    }

    // pass 2: backward; A*, S* now sum the slots after the current one
    const float* bgc = p.bg_rgb ? p.bg_rgb + 3 * (int64_t)r : nullptr;
    float Sigma = (bgc ? Gc[0] * bgc[0] + Gc[1] * bgc[1] + Gc[2] * bgc[2]
                       : p.bg * (Gc[0] + Gc[1] + Gc[2])) * expf(pre_c);
    if constexpr (kOut) {
        if (q.g_log_T) Sigma = Sigma + q.g_log_T[r];  // log_T sums every slot's log(1 - alpha)
    }
    Aw = Sw = Aa = Sa = 0.0f;
    for (int64_t e = e1 - 1; e >= e0; --e) {
        int s_best = -1;
        if constexpr (kOut) {
            if (g_mode != 0.0f && !q.mode_first) {
                float w_best;
                const int sb = entry_best(p, e, w_best);
                if (w_best == k.wmax && w_best > 0.0f && p.t[(int64_t)sb * p.M + e] == k.t_mode)
                    s_best = sb;
            }
        }
        for (int s = p.S0 - 1; s >= 0; --s) {
            const int64_t i = (int64_t)s * p.M + e;
            cnt -= p.counted[i];
            const float at = p.d_alpha[i];
            float dt_out = 0.0f;  // the cotangent of t from the outputs that read every slot
            if constexpr (kOut) {
                if (q.g_st) dt_out = q.g_st[i];
                if (q.g_pts) {
                    const float* gp = q.g_pts + 3 * (e * p.S0 + s);
                    dt_out = dt_out + (gp[0] * dir[0] + gp[1] * dir[1] + gp[2] * dir[2]);
                }
            }
            if (at < 0.0f) {
                p.d_alpha[i] = 0.0f;
                p.d_t[i] = 0.0f;
                for (int c = 0; c < 3; ++c) p.d_col[c * SM + i] = 0.0f;
                if constexpr (kOut) {
                    if (q.g_sa) p.d_alpha[i] = q.g_sa[i];
                    p.d_t[i] = dt_out;
                    if (q.d_snorm)
                        for (int c = 0; c < 3; ++c) q.d_snorm[c * SM + i] = 0.0f;
                }
                continue;
            }
            const float T = p.d_col[2 * SM + i];
            const float om = one_minus(at);
            const float w = T * (1.0f - om);
            const bool inc = p.fake_l_dist || !p.fake[i];
            const float wi = inc ? w : 0.0f, a = inc ? at : 0.0f;
            const float t = p.t[i];
            float Wbar = Gc[0] * p.rgb[i];
            Wbar = Wbar + Gc[1] * p.rgb[SM + i];
            Wbar = Wbar + Gc[2] * p.rgb[2 * SM + i];
            float abar = (g_sls + g_slsw * w) * logsig_grad(at);
            float dt = p.d_t[i];
            if (inc) {
                Wbar = Wbar + p.d_col[i] + g_ld * (Sw - t * Aw);
                if (wi > 0.0f) Wbar = Wbar + g_ent * entropy_grad(wi);
                abar = abar + p.d_col[SM + i] + g_lda * (Sa - t * Aa);
                if (a > 0.0f) abar = abar + g_enta * entropy_grad(a);
                dt = dt - g_ld * wi * Aw - g_lda * a * Aa;
            }
            const int kc = --n_contrib;  // the slot's cache column
            if (p.g_cts && kc < p.cache_K) {
                const int64_t ck = (int64_t)r * p.cache_K + kc;
                Wbar = Wbar + p.g_cw[ck];
                abar = abar + p.g_calpha[ck];
                dt = dt + p.g_cts[ck];
            }
            float d_sa = 0.0f;
            if constexpr (kOut) {
                // depth = sum w t; normal = sum w n
                Wbar = Wbar + gd * t;
                dt = dt + gd * w + dt_out;
                if (q.g_normal) {
                    const float* sn = q.snorm + i;
                    Wbar = Wbar + (gn[0] * sn[0] + gn[1] * sn[SM] + gn[2] * sn[2 * SM]);
                    for (int c = 0; c < 3; ++c) q.d_snorm[c * SM + i] = gn[c] * w;
                }
                if (q.g_sw) Wbar = Wbar + q.g_sw[i];
                if (q.g_sac) abar = abar + q.g_sac[i];
                if (q.g_sa) d_sa = q.g_sa[i];
                // the depths that pick one sample (or split over tied ones)
                if (g_mode != 0.0f && (q.mode_first ? i == k.i_mode : s == s_best))
                    dt = dt + g_mode;
                if (g_med != 0.0f && t == k.t_med &&
                    (i == k.i_med || (k.n_med > 1 && median_hit(p, e0, e1, k.thr, i))))
                    dt = dt + g_med;
                if (g_sig != 0.0f && !p.fake[i] && p.alpha[i] > q.sig_thresh && t == k.t_sig)
                    dt = dt + g_sig;
                if (g_cmed != 0.0f && kc == k.k_med) dt = dt + g_cmed;
            }
            const float d_om = -T * Wbar + Sigma / om;
            const float d_at = abar - d_om * clip_grad(1.0f - at, 1e-7f, 1.0f - 1e-7f);
            const float rw = p.truncated ? trunc_rw(cnt - (p.fake[i] ? 1 : 0), ta, p.trunc_wmin) : 1.0f;
            p.d_alpha[i] = kOut ? d_at * rw + d_sa : d_at * rw;
            p.d_t[i] = dt;
            for (int c = 0; c < 3; ++c) p.d_col[c * SM + i] = Gc[c] * w;
            Sigma = Sigma + Wbar * w;
            Aw = Aw + wi;
            Sw = Sw + wi * t;
            Aa = Aa + a;
            Sa = Sa + a * t;
        }
    }
}

// ---------------------------------------------------------------------------
// K5b
// ---------------------------------------------------------------------------

struct BackEntryParams {
    const int* ray_id;
    const int* l;
    const float* close_t;
    const float* far_t;
    int64_t M;
    int B;
    const float* origins;
    const float* dirs;
    const float* sh_mult;
    int bd;
    const int* links;
    int X, Y, Z;
    const float* packed;
    int cap, C8, n_surf_c;
    const float* level_sets;
    int n_lv;
    int S0;
    int stype;
    const float* lv_alpha;  // UDF_ALPHA's (n_lv,) alphas, else null
    float near_grid_t, sigma_thresh;
    const float* fs_std;  // (1,) or null
    float min_vox_len;
    int only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid, no_sh_surf_grad;
    const bool* contrib;  // (S0, M) from K3
    const float* d_alpha;
    const float* d_t;
    const float* d_col;
    const float* g_rl;
    const bool* win;   // (M,) K4's count window, or null: every entry
    float* g_density;  // (cap,), or UDF_ALPHA's (n_lv,) table
    float* g_surface;  // (cap, n_surf_c)
    float* g_sh;       // (cap, 3 bd)
    float* g_fss;      // (1,) or null
    float* g_sh_mult;  // (B, bd) or null
    const float* d_snorm;  // (3, S0, M) the normal's cotangent (the second instantiation), or null
};

// what the sh_mult gradient needs of one entry: its ray, the 8 corner rows
// and the colour cotangent of each (corner, channel); ray -1: nothing
struct ShMultGrad {
    int ray;
    int link[8];
    float dC[3][8];
};

// the entry's part of g_sh_mult[ray, b]
HD float sh_mult_grad(const BackEntryParams& p, const ShMultGrad& sg, int b) {
    if (sg.ray < 0) return 0.0f;
    const int sh_base = 1 + p.n_surf_c;
    float acc = 0.0f;
    for (int c = 0; c < 8; ++c) {
        const float* row = p.packed + (int64_t)sg.link[c] * p.C8 + sh_base;
        for (int ch = 0; ch < 3; ++ch) acc = acc + sg.dC[ch][c] * row[ch * p.bd + b];
    }
    return acc;
}

// vector-Jacobian product of trilerp_weights at (x, y, z)
HD void trilerp_weights_vjp(const float fs[3], const float dw[8], float dfs[3]) {
    dfs[0] = dfs[1] = dfs[2] = 0.0f;
    for (int c = 0; c < 8; ++c) {
        const float wx = corner_dx(c) ? fs[0] : 1.0f - fs[0];
        const float wy = corner_dy(c) ? fs[1] : 1.0f - fs[1];
        const float wz = corner_dz(c) ? fs[2] : 1.0f - fs[2];
        const float sx = corner_dx(c) ? 1.0f : -1.0f;
        const float sy = corner_dy(c) ? 1.0f : -1.0f;
        const float sz = corner_dz(c) ? 1.0f : -1.0f;
        dfs[0] = dfs[0] + dw[c] * (sx * (wy * wz));
        dfs[1] = dfs[1] + dw[c] * (wx * (sy * wz));
        dfs[2] = dfs[2] + dw[c] * (wx * (wy * sz));
    }
}

// vector-Jacobian product of the unit normal n = -g / sqrt(max(|g|^2, 1e-20))
// at g: (I - n n^T) dn / -|g| above the floor, -dn / 1e-10 below it (the
// floor is a constant there, as JAX's where)
HD void unit_normal_vjp(const float g[3], const float dn[3], float dg[3]) {
    const float nsq = dot3(g, g);
    if (nsq > 1e-20f) {
        const float den = sqrtf(nsq);
        const float n[3] = {-g[0] / den, -g[1] / den, -g[2] / den};
        const float nd = dot3(n, dn);
        for (int a = 0; a < 3; ++a) dg[a] = -(dn[a] - n[a] * nd) / den;
    } else {
        const float den = sqrtf(1e-20f);
        for (int a = 0; a < 3; ++a) dg[a] = -dn[a] / den;
    }
}

// vector-Jacobian product of field_grad(s8, fs) (trilinear in the corner
// values, bilinear in the position): each corner value's direct term into
// dS8, and into dfs the mixed second derivatives of the trilinear weights
// (the pure ones are 0)
HD void field_grad_vjp(const float s8[8], const float fs[3], const float dg[3], float dS8[8],
                       float dfs[3]) {
    for (int c = 0; c < 8; ++c) {
        const float wx = corner_dx(c) ? fs[0] : 1.0f - fs[0];
        const float wy = corner_dy(c) ? fs[1] : 1.0f - fs[1];
        const float wz = corner_dz(c) ? fs[2] : 1.0f - fs[2];
        const float sx = corner_dx(c) ? 1.0f : -1.0f;
        const float sy = corner_dy(c) ? 1.0f : -1.0f;
        const float sz = corner_dz(c) ? 1.0f : -1.0f;
        dS8[c] = dS8[c] + (dg[0] * (sx * (wy * wz)) + dg[1] * (wx * (sy * wz)) +
                           dg[2] * (wx * (wy * sz)));
        const float hxy = sx * (sy * wz), hxz = sx * (wy * sz), hyz = wx * (sy * sz);
        dfs[0] = dfs[0] + s8[c] * (dg[1] * hxy + dg[2] * hxz);
        dfs[1] = dfs[1] + s8[c] * (dg[0] * hxy + dg[2] * hyz);
        dfs[2] = dfs[2] + s8[c] * (dg[0] * hxz + dg[1] * hyz);
    }
}

// |f'| < 1e-10 becomes sign(f') 1e-10, and 1e-10 where f' == 0 (cubic.py:236)
HD float safe_fp(float fp) {
    if (fabsf(fp) >= 1e-10f) return fp;
    return fp < 0.0f ? -1e-10f : 1e-10f;
}

// d min(a, b) / d a, JAX's (and torch's) half at a tie
HD float min_grad(float a, float b) { return a < b ? 1.0f : (a == b ? 0.5f : 0.0f); }

// One real slot's cotangents: the raw alpha's (returned in draw; into the
// corner alphas unless the alpha comes from UDF_ALPHA's table) and the
// colours' (into dC). Returns the cotangent of the slot's t: d_t plus that
// of the sample position, which moves with t. kNormal: the rendered
// normal's cotangent too, into the corner surface values (dS8) and the
// position through the field's gradient, or for PLANE (plane_abc, its mean
// plane's normal) into dP's a, b, c.
template <bool kNormal>
HD float real_slot_vjp(const BackEntryParams& p, const Corners& cs, const RealSlot& s, int64_t k,
                       const float d[3], float g_in, float g_lap, float dA8[8], float dC[3][8],
                       float& draw, float dS8[8], const float* plane_abc, float dP[4]) {
    const int64_t SM = (int64_t)p.S0 * p.M;
    draw = 0.0f;
    float da = p.d_alpha[k];
    if (p.contrib[k]) {
        const float alpha = alpha_act(s.raw, p.act_sigmoid);
        da = da + g_in * inward_sq(s.sn, d) + g_lap * lap_grad(alpha);
    }
    const float dcol[3] = {p.d_col[k], p.d_col[SM + k], p.d_col[2 * SM + k]};
    const float dt_in = p.d_t[k];
    float dn[3] = {0.0f, 0.0f, 0.0f};
    bool has_dn = false;
    if constexpr (kNormal) {
        for (int a = 0; a < 3; ++a) dn[a] = p.d_snorm[a * SM + k];
        has_dn = dn[0] != 0.0f || dn[1] != 0.0f || dn[2] != 0.0f;
    }
    if (da == 0.0f && dt_in == 0.0f && dcol[0] == 0.0f && dcol[1] == 0.0f && dcol[2] == 0.0f &&
        !has_dn)
        return 0.0f;
    draw = da * alpha_act_grad(s.raw, p.act_sigmoid);
    float dw8[8];
    for (int c = 0; c < 8; ++c) {
        if (!p.lv_alpha) dA8[c] = dA8[c] + draw * s.w8[c];
        dw8[c] = p.lv_alpha ? 0.0f : draw * cs.alpha8[c];
    }
    for (int ch = 0; ch < 3; ++ch) {
        const float dpre = dcol[ch] * clip_lo_grad(s.pre_rgb[ch], 0.0f);
        for (int c = 0; c < 8; ++c) {
            dC[ch][c] = dC[ch][c] + dpre * s.w8[c];
            if (!p.no_sh_surf_grad) dw8[c] = dw8[c] + dpre * cs.crgb[ch][c];
        }
    }
    // the sample position: clip(where(geo_ok, o + t d - l, 0.5), 0, 1)
    float dfs[3];
    trilerp_weights_vjp(s.fs, dw8, dfs);
    if constexpr (kNormal) {
        if (has_dn) {
            // snorm = unit_normal(sgrad), sgrad the field's gradient at fs
            // (or PLANE's abc); a mask for only_outward_intersect
            float g[3], dg[3];
            if (plane_abc)
                for (int a = 0; a < 3; ++a) g[a] = plane_abc[a];
            else
                field_grad(cs.surf8, s.fs[0], s.fs[1], s.fs[2], g);
            unit_normal_vjp(g, dn, dg);
            if (plane_abc)
                for (int a = 0; a < 3; ++a) dP[a] = dP[a] + dg[a];
            else
                field_grad_vjp(cs.surf8, s.fs, dg, dS8, dfs);
        }
    }
    float dt = dt_in;
    if (s.geo_pre)
        for (int a = 0; a < 3; ++a) dt = dt + dfs[a] * clip_grad(s.frac[a], 0.0f, 1.0f) * d[a];
    return dt;
}

// PLANE: the cotangent dt of t_pl = -(abc . o + dpl) / den into the mean
// plane (a, b, c, d), dpl = min(max(d, lo), hi), lo/hi = -+0.3 - xyz
HD void plane_root_vjp(const PlaneRoot& q, float p3, const float o[3], const float d[3],
                       const int l[3], float dt, float dP[4]) {
    const float dN = -dt / q.den;
    const float dden = fabsf(q.den_raw) < 1e-12f ? 0.0f : dt * q.N / (q.den * q.den);
    const float g_m = dN * min_grad(q.m, q.hi);
    const float g_hi = dN * min_grad(q.hi, q.m);
    const float g_lo = g_m * clip_lo_grad(q.lo, p3);
    const float dxyz = -(g_lo + g_hi);
    for (int k = 0; k < 3; ++k)
        dP[k] = dP[k] + dN * o[k] + dden * d[k] + dxyz * ((float)l[k] + 0.5f);
    dP[3] = dP[3] + g_m * clip_lo_grad(p3, q.lo);
}

// add v to level set i's alpha cotangent: the thread's sum, or past the
// first MAX_LV_TABLE level sets the table row itself
HD void add_table(const BackEntryParams& p, float* gtab, int i, float v) {
    if (i < MAX_LV_TABLE)
        gtab[i] = gtab[i] + v;
    else if (v != 0.0f)
        atomic_add(p.g_density + i, v);
}

// returns this entry's part of the fake_sample_std gradient; fills sg for
// the sh_mult gradient (sg.ray stays -1 for an entry that adds nothing)
// and, for UDF_ALPHA, adds each level set's alpha cotangent to gtab
template <bool kNormal>
HD float backward_entry_thread(const BackEntryParams& p, int64_t m, ShMultGrad& sg, float* gtab) {
    const int r = p.ray_id[m];
    const int l[3] = {p.l[3 * m], p.l[3 * m + 1], p.l[3 * m + 2]};
    const float close_t = p.close_t[m], far_t = p.far_t[m];
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    const float* shm = p.sh_mult + (int64_t)r * p.bd;
    Corners cs;
    float pl[4];  // PLANE's mean plane
    gather_corners(p.links, p.X, p.Y, p.Z, p.packed, p.cap, p.C8, p.n_surf_c, p.bd, shm,
                   p.sigma_thresh, p.stype, l, cs, p.stype == SURF_PLANE ? pl : nullptr);
    if (!cs.vox_ok) return 0.0f;  // no slot of the entry contributes

    const int64_t SM = (int64_t)p.S0 * p.M;
    const bool in_win = !p.win || p.win[m];
    const float g_in = in_win ? p.g_rl[7 * p.B + r] : 0.0f;
    const float g_lap = in_win ? p.g_rl[8 * p.B + r] : 0.0f;
    const float g_udf = in_win ? p.g_rl[10 * p.B + r] : 0.0f;
    float dA8[8], dS8[8], dC[3][8], dP[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 8; ++c) {
        dA8[c] = dS8[c] = 0.0f;
        for (int ch = 0; ch < 3; ++ch) dC[ch][c] = 0.0f;
    }
    float g_fss = 0.0f;

    if (p.stype == SURF_VOXEL_FACE) {
        // alpha = sigmoid(corner 0's raw alpha); the colour at the entry
        FaceSlot f;
        face_slot(cs, o, d, l, close_t, p.near_grid_t, p.X, p.Y, p.Z, f);
        float da = p.d_alpha[m];
        if (p.contrib[m]) da = da + g_lap * lap_grad(f.alpha);  // its normal is 0: no inward term
        dA8[0] = da * (f.alpha * (1.0f - f.alpha));
        for (int ch = 0; ch < 3; ++ch) {
            const float dpre = p.d_col[ch * SM + m] * clip_lo_grad(f.pre_rgb[ch], 0.0f);
            for (int c = 0; c < 8; ++c) dC[ch][c] = dC[ch][c] + dpre * f.ew8[c];
        }
    } else if (p.stype == SURF_PLANE) {
        PlaneRoot q;
        plane_root(pl, o, d, l, q);
        RealSlot s;
        real_slot(cs, o, d, l, close_t, q.t_pl - close_t, cs.vox_ok && q.t_pl > 0.0f,
                  p.near_grid_t, p.only_outward, q.abc, s);
        float draw;
        const float dt = real_slot_vjp<kNormal>(p, cs, s, m, d, g_in, g_lap, dA8, dC, draw, dS8,
                                                q.abc, dP);
        // t = close_t + (t_pl - close_t): its cotangent is t_pl's
        if (dt != 0.0f) plane_root_vjp(q, pl[3], o, d, l, dt, dP);
    } else {
        float smin = cs.surf8[0], smax = cs.surf8[0];
        for (int c = 1; c < 8; ++c) {
            smin = fminf(smin, cs.surf8[c]);
            smax = fmaxf(smax, cs.surf8[c]);
        }
        float u[3], f[4];
        for (int a = 0; a < 3; ++a) u[a] = o[a] + close_t * d[a] - (float)l[a];
        cubic_coeffs(cs.surf8, u, d, f);

        float df[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        bool vox_has_sample = false, vox_has_surf = false;
        int n_lv_hull = 0;
        for (int i = 0; i < p.n_lv; ++i) {
            const float lv = p.level_sets[i];
            const bool lv_ok = cs.vox_ok && lv >= smin && lv <= smax;
            vox_has_surf = vox_has_surf || lv_ok;
            n_lv_hull += lv_ok ? 1 : 0;
            float roots[3];
            bool has[3];
            cubic_roots(f[0] - lv, f[1], f[2], f[3], roots, has);
            for (int j = 0; j < 3; ++j) {
                RealSlot s;
                real_slot(cs, o, d, l, close_t, roots[j], lv_ok, p.near_grid_t, p.only_outward,
                          nullptr, s);
                if (p.lv_alpha) s.raw = p.lv_alpha[i];
                vox_has_sample = vox_has_sample || s.geo_pre;
                float draw;
                const float dt = real_slot_vjp<kNormal>(p, cs, s, (int64_t)(3 * i + j) * p.M + m,
                                                        d, g_in, g_lap, dA8, dC, draw, dS8,
                                                        nullptr, dP);
                if (p.lv_alpha) add_table(p, gtab, i, draw);
                // t = close_t + root; the root moves with the coefficients
                if (has[j] && dt != 0.0f) {
                    const float ts = roots[j];
                    const float fp = 3.0f * f[3] * ts * ts + 2.0f * f[2] * ts + f[1];
                    const float gt = -dt / safe_fp(fp);
                    df[0] = df[0] + gt;
                    df[1] = df[1] + gt * ts;
                    df[2] = df[2] + gt * ts * ts;
                    df[3] = df[3] + gt * ts * ts * ts;
                }
            }
        }
        if (df[0] != 0.0f || df[1] != 0.0f || df[2] != 0.0f || df[3] != 0.0f) {
            // the coefficients are linear in the corner values: f(e_c) is d f / d s_c
            for (int c = 0; c < 8; ++c) {
                float e[8], fc[4];
                for (int k = 0; k < 8; ++k) e[k] = k == c ? 1.0f : 0.0f;
                cubic_coeffs(e, u, d, fc);
                dS8[c] = dS8[c] + df[0] * fc[0] + df[1] * fc[1] + df[2] * fc[2] + df[3] * fc[3];
            }
        }

        if (p.fake_sample) {
            const float fss = p.fs_std ? p.fs_std[0] : 1.0f;
            FakeSlot fk;
            fake_slot(cs, o, d, l, close_t, far_t, vox_has_sample, vox_has_surf, p.min_vox_len,
                      p.limited_fake, p.normalize_surf, p.level_sets, p.n_lv, p.sigma_thresh,
                      fss, p.act_sigmoid, p.lv_alpha, fk);
            const int64_t k = (int64_t)(p.S0 - 1) * p.M + m;
            float da = p.d_alpha[k];
            if (p.contrib[k]) da = da + g_in * inward_sq(fk.fsn, d) + g_lap * lap_grad(fk.falpha);
            const float dcol[3] = {p.d_col[k], p.d_col[SM + k], p.d_col[2 * SM + k]};
            if (da != 0.0f || dcol[0] != 0.0f || dcol[1] != 0.0f || dcol[2] != 0.0f) {
                // falpha = alpha_act(fraw) * exp(-q^2 / 2), q = fake_dist / fss
                const float draw = da * fk.gauss * alpha_act_grad(fk.fraw, p.act_sigmoid);
                if (p.lv_alpha)
                    add_table(p, gtab, fk.amin, draw);
                else
                    for (int c = 0; c < 8; ++c) dA8[c] = dA8[c] + draw * fk.fw8[c];
                const float dq = da * fk.base * (fk.gauss * -fk.q);
                g_fss = dq * (-fk.q / fss);
                const float ds = dq / fss;  // d fake_dist = d s_norm
                if (p.normalize_surf) {
                    // s_norm = sum_c fw8 s_c / std, std = sqrt(max(var, 1e-9))
                    for (int c = 0; c < 8; ++c) dS8[c] = dS8[c] + ds * (fk.fw8[c] / fk.std_);
                    const float dstd = -ds * fk.s_norm / fk.std_;
                    const float dvar = dstd * (0.5f / fk.std_) * clip_lo_grad(fk.var, 1e-9f);
                    float dmu = 0.0f;
                    for (int c = 0; c < 8; ++c) {
                        const float gv = dvar * (2.0f * (cs.surf8[c] - fk.mu) / 8.0f);
                        dS8[c] = dS8[c] + gv;
                        dmu = dmu - gv;
                    }
                    for (int c = 0; c < 8; ++c) dS8[c] = dS8[c] + dmu / 8.0f;
                } else {
                    for (int c = 0; c < 8; ++c) dS8[c] = dS8[c] + ds * fk.fw8[c];
                }
                for (int ch = 0; ch < 3; ++ch) {
                    const float dpre = dcol[ch] * clip_lo_grad(fk.pre_rgb[ch], 0.0f);
                    for (int c = 0; c < 8; ++c) dC[ch][c] = dC[ch][c] + dpre * fk.fw8[c];
                }
            }
        }

        if (is_udf(p.stype)) {
            // the udf-var term: factor * sum_c (s_c - mu)^2 / 7
            const float kf = udf_hull_factor(p.stype, n_lv_hull, p.n_lv, p.fake_sample,
                                             p.limited_fake);
            const float gv = g_udf * kf / 7.0f;
            if (gv != 0.0f) {
                float mu;
                udf_var(cs.surf8, mu);
                float dmu = 0.0f;
                for (int c = 0; c < 8; ++c) {
                    const float e = gv * (2.0f * (cs.surf8[c] - mu));
                    dS8[c] = dS8[c] + e;
                    dmu = dmu - e;
                }
                for (int c = 0; c < 8; ++c) dS8[c] = dS8[c] + dmu / 8.0f;
            }
            // the corner values are softplus of the rows
            for (int c = 0; c < 8; ++c)
                if (dS8[c] != 0.0f) dS8[c] = dS8[c] * softplus_grad(cs.sraw[c]);
        }
    }

    const int nsh = 3 * p.bd;
    sg.ray = r;
    for (int c = 0; c < 8; ++c) {
        sg.link[c] = cs.link[c];
        for (int ch = 0; ch < 3; ++ch) sg.dC[ch][c] = dC[ch][c];
    }
    for (int c = 0; c < 8; ++c) {
        const int64_t row = cs.link[c];  // present: vox_ok holds
        if (!p.lv_alpha && dA8[c] != 0.0f) atomic_add(p.g_density + row, dA8[c]);
        if (p.stype == SURF_PLANE) {
            for (int k = 0; k < 4; ++k) {
                const float v = dP[k] / 8.0f;  // the mean's share of each corner
                if (v != 0.0f) atomic_add(p.g_surface + row * p.n_surf_c + k, v);
            }
        } else if (dS8[c] != 0.0f) {
            atomic_add(p.g_surface + row * p.n_surf_c, dS8[c]);
        }
        for (int ch = 0; ch < 3; ++ch) {
            if (dC[ch][c] == 0.0f) continue;
            for (int b = 0; b < p.bd; ++b)
                atomic_add(p.g_sh + row * nsh + ch * p.bd + b, dC[ch][c] * shm[b]);
        }
    }
    return g_fss;
}

#ifdef __CUDACC__
template <bool kOut>
__global__ void backward_ray_kernel(BackRayParams p, BackRayOut q) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) backward_ray_thread<kOut>(p, q, r);
}

// the sum of v over the lanes from this one to the last lane of the warp
// that holds the same key (keys contiguous in the warp: the sum is exact at
// each key's first lane)
__device__ __forceinline__ float segment_sum(float v, int key) {
    const int lane = threadIdx.x & 31;
    for (int off = 1; off < 32; off <<= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int ok = __shfl_down_sync(0xffffffffu, key, off);
        if (lane + off < 32 && ok == key) v += ov;
    }
    return v;
}

template <bool kShMult, bool kNormal>
__global__ void backward_entry_kernel(BackEntryParams p) {
    const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    ShMultGrad sg;
    sg.ray = -1;
    float gtab[MAX_LV_TABLE];  // UDF_ALPHA's level-set alpha cotangents of this entry
    const int n_tab = p.lv_alpha ? min(p.n_lv, MAX_LV_TABLE) : 0;
    for (int i = 0; i < n_tab; ++i) gtab[i] = 0.0f;
    float g = m < p.M ? backward_entry_thread<kNormal>(p, m, sg, gtab) : 0.0f;
    g = warp_sum(g);
    if ((threadIdx.x & 31) == 0 && g != 0.0f && p.g_fss) atomicAdd(p.g_fss, g);
    if (p.lv_alpha) {
        // every entry adds to the few rows of the table: one atomic a warp and row
        for (int i = 0; i < n_tab; ++i) {
            const float v = warp_sum(gtab[i]);
            if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(p.g_density + i, v);
        }
    }
    if (kShMult) {
        // every lane takes part in the shuffles, the tail's (m >= M) too
        const int r = m < p.M ? p.ray_id[m] : -1;
        const int r_prev = __shfl_up_sync(0xffffffffu, r, 1);
        const bool first = (threadIdx.x & 31) == 0 || r_prev != r;
        for (int b = 0; b < p.bd; ++b) {
            const float v = segment_sum(sh_mult_grad(p, sg, b), r);
            if (first && r >= 0 && v != 0.0f) atomicAdd(p.g_sh_mult + (int64_t)r * p.bd + b, v);
        }
    }
}

// K5a. ``out``, a host pointer to the output cotangents (BackRayOut) or
// null, chooses the instantiation: null the rgb-only one, else the second,
// which needs K3's normals and writes d_snorm when g_normal is given.
extern "C" cudaError_t backward_ray(const int64_t* offsets, int B, long long M, int S0,
                                    const float* t, const float* alpha, const bool* contrib,
                                    const bool* fake, const int* counted, const float* rgb,
                                    int truncated, const float* trunc_a, float trunc_wmin,
                                    int stop_on, float log_stop, float bg,
                                    const float* bg_rgb, int fake_l_dist,
                                    const float* g_rgb, const float* g_rl, float* d_alpha,
                                    float* d_t, float* d_col, int cache_K, const float* g_cts,
                                    const float* g_calpha, const float* g_cw,
                                    const BackRayOut* out, void* stream) {
    if (B <= 0) return cudaSuccess;
    const BackRayParams p{offsets, B, M, S0, t, alpha, contrib, fake, counted, rgb, truncated,
                          trunc_a, trunc_wmin, stop_on, log_stop, bg, bg_rgb, fake_l_dist,
                          g_rgb, g_rl,
                          d_alpha, d_t, d_col, cache_K, g_cts, g_calpha, g_cw};
    const int block = 128;
    const unsigned grid = (B + block - 1) / block;
    if (out) {
        if (!out->snorm || (out->g_normal != nullptr) != (out->d_snorm != nullptr))
            return cudaErrorInvalidValue;
        backward_ray_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(p, *out);
    } else {
        backward_ray_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(p, BackRayOut{});
    }
    return cudaGetLastError();
}

// the launcher of both K5b instantiations: d_snorm null for the rgb-only
// one, the normal's cotangent for the second
static cudaError_t launch_backward_entry(const BackEntryParams& p, cudaStream_t stream) {
    if (p.M <= 0) return cudaSuccess;
    const int block = 128;
    const unsigned grid = (unsigned)((p.M + block - 1) / block);
    if (p.d_snorm) {
        if (p.g_sh_mult)
            backward_entry_kernel<true, true><<<grid, block, 0, stream>>>(p);
        else
            backward_entry_kernel<false, true><<<grid, block, 0, stream>>>(p);
    } else if (p.g_sh_mult) {
        backward_entry_kernel<true, false><<<grid, block, 0, stream>>>(p);
    } else {
        backward_entry_kernel<false, false><<<grid, block, 0, stream>>>(p);
    }
    return cudaGetLastError();
}

// K5b. d_snorm, the cotangent of each slot's rendered normal (3, S0, M), or
// null, chooses the instantiation.
extern "C" cudaError_t backward_entry(
    const int* ray_id, const int* l, const float* close_t, const float* far_t, long long M, int B,
    const float* origins, const float* dirs, const float* sh_mult, int bd, const int* links,
    int X, int Y, int Z, const float* packed, int cap, int C8, int n_surf_c,
    const float* level_sets, int n_lv, int S0, int stype, const float* lv_alpha,
    float near_grid_t, float sigma_thresh, const float* fs_std, float min_vox_len,
    int only_outward, int fake_sample, int limited_fake, int normalize_surf, int act_sigmoid,
    int no_sh_surf_grad, const bool* contrib, const float* d_alpha, const float* d_t,
    const float* d_col, const float* g_rl, const bool* win, float* g_density, float* g_surface,
    float* g_sh, float* g_fss, float* g_sh_mult, const float* d_snorm, void* stream) {
    const BackEntryParams p{ray_id, l, close_t, far_t, M, B, origins, dirs, sh_mult, bd, links,
                            X, Y, Z, packed, cap, C8, n_surf_c, level_sets, n_lv, S0, stype,
                            lv_alpha, near_grid_t, sigma_thresh, fs_std, min_vox_len,
                            only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid,
                            no_sh_surf_grad, contrib, d_alpha, d_t, d_col, g_rl, win, g_density,
                            g_surface, g_sh, g_fss, g_sh_mult, d_snorm};
    return launch_backward_entry(p, (cudaStream_t)stream);
}
#endif
