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
// K5a, backward_ray: per ray, from the slots' t, alpha, flags and colours,
// the cotangents of each slot's pre-truncation alpha, t and clipped colour.
// A forward pass recomputes what K4 computed (truncation by running
// intersection index, the stop_thresh kill of whole entries,
// transmittance, weights) and parks in the output arrays what the backward
// pass needs: the slot's truncated alpha (-1 where it does not
// contribute), its transmittance, and the prefix parts of the l_dist(_a)
// derivatives. The backward pass walks back and turns them into per-slot
// cotangents: the suffix sum Sigma carries d loss / d log(1 - alpha) of
// every later slot plus the background term; the l_dist(_a) pairs split
// into a prefix part (forward) and a suffix part (backward), so every sum
// is a running sum and none is a difference of totals.
//
// K5b, backward_entry: per pool entry, like K3. It recomputes the entry's
// samples with the very code of K3 (samples.cuh) and chains the slot
// cotangents, plus the inward-norm and density-lap terms of ray_losses, into
// the 8 corner rows: density through the trilinear weights; SH through the
// weights times the SH basis where the colour was not clipped; surface
// through the root (implicit differentiation: dt/df_i = -t^i / f'(t), |f'|
// kept >= 1e-10) and the cubic's coefficients, through the sample position
// into the weights, and through the fake sample's normalised surface value
// and the std of the 8 corners; fake_sample_std through the Gaussian
// reweight (summed over the warp first: every entry adds to that one
// address).
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
// a level set past those adds its own atomics.
//
// K11d, the gradient through the first-K sample cache (K11c): the
// cotangents of the cached ts, alphas and weights, (B, cache_K) each, join
// K5a's per-slot cotangents at the slot's cache column (its index among
// the ray's contributing slots: K4 filled the columns in walk order): the
// weight's to the slot's weight cotangent (the suffix rule carries it to
// every earlier alpha), the alpha's to the truncated alpha's, the t's to
// d_t, which K5b takes through the cubic root's JVP. backward_entry skips
// the inward/lap terms of entries outside K4's count window (win).
//
// The learned bases (a 3D texture or an MLP of the view direction) train
// through the per-ray basis sh_mult (B, bd): with a g_sh_mult output, K5b
// also gives g_sh_mult[r, b] = sum_c sum_ch dC[ch][c] * row_c[ch bd + b],
// the colour cotangents dC that scatter into the SH rows, contracted with
// the corner rows instead of the basis. A ray's pool entries are
// contiguous, so each warp sums them per ray with a segmented shuffle and
// the first lane of each ray in the warp issues bd atomics.
//
// The outputs' cotangents, K5a's second instantiation (kOut): depth (d w +=
// g t, d t += g w), normal (d w += g . n; d_snorm = g w, 3 floats a slot for
// K5b), log_T (joins Sigma), the intersections' points (into d t through the
// ray's direction and grid2world's scale, on every slot), pre-truncation
// alphas (into d_alpha) and weights, and the samples' t, weights and
// truncated alphas. The depths that pick one sample take K4's rules on K4's
// float32 weights: the mode (the packed rule: the largest t among the
// entries whose first max-weight slot holds the ray's max; the walks' rule:
// the first max-weight slot), the median and the cache's median (K4's
// sums in K4's order, so the same samples), the sigma-thresh depth (the
// smallest t of a live real slot above the threshold). Ties split the
// cotangent evenly, as jax.grad of a min or max does. K5b's second
// instantiation (kNormal) carries d_snorm through the unit normal's Jacobian
// ((I - n n^T) / -|g| above the 1e-20 floor, 1 / -1e-10 below it) into the
// field's gradient: each corner value's direct term and, through the
// trilinear weights' mixed second derivatives, the sample position, whose
// cotangent then joins the root's JVP (PLANE: into the mean plane's a, b,
// c). Both are template parameters: the rgb-only code carries none of it.
//
// Bound: K5a by bytes (each slot's t, alpha, colour and flags read, its
// cotangents written: about 46 bytes a slot), K5b by bytes (the pool, the 8
// corner rows of each entry, the slot cotangents and the gradient rows).
// Clamps and maxima take JAX's derivative at an exact tie (half the
// gradient), so the kernels and the plain version (autograd of the plain
// renderer) agree on ties in float32.
//
// Design (the H100), K5a: a ray on G = kK4Lanes = 16 lanes, lane k on its
// entry base + k, as K4 (composite.cu): a pool holds ~3 entries a ray on
// the serving chunk and ~280 on a dense type pool, and one thread a ray
// left the warps idle and the launch as long as its longest ray's two
// serial walks. The forward pass is K4's, group by group from the ray's
// first entry: the same per-entry values through the same warp scans
// (warp_prefix, warp_allsum), so the kill, the weights, log_T and every
// pick have K4's bits by construction; the truncation index and the cache
// positions are integer scans. The median's sweep is K4's too, and marks
// each hit of its test in the sign bit of the slot's parked transmittance,
// so the backward pass finds the tied hits without a re-walk; the cache
// median reads the cached weights column by column, each lane walking to
// its columns. The backward pass sweeps the same groups from the ray's
// last to its first: every suffix quantity is the entry's own suffix
// (slots from S0 - 1 down) plus an exclusive warp suffix over the group's
// later lanes, carried from the later groups: first l_dist's sums Aw, Sw,
// Aa, Sa (t measured from the ray's first contributing sample, as K4:
// unshifted, t ~ 700 at 512^3 cancels to 1e-4), then each slot's Wbar and
// abar, then Sigma, the suffix of Wbar w. The truncation index and the
// cache column come back as the totals less integer suffix scans (exact).
// Float sums are taken in tree order, not the serial walk's: the
// gradients move by rounding, the kill and the picks do not.
//
// Design, K5b: an entry on G = 4 lanes, as K3 (phase_b.cu), a template on
// the surface type. Lane lg reads corners lg and lg + 4 in 16-byte loads
// through K3's row reader (samples.cuh's gather_corners_lanes: K3's corner
// values bit for bit, so K3's contrib gate), lane j takes slot j's
// vector-Jacobian product (root j mod 3 of level set j / 3, with its root
// JVP; j + G, ... when S0 > G) and the lane of slot S0 - 1 the fake
// sample, whose vox_has_sample and vox_has_surf come from a group ballot.
// The group then sums its per-corner cotangents by a reduce-scatter, so
// that each lane holds its own two corners' sums, and each lane adds its
// two rows: density and surface by scalar atomics, the SH row's 3 bd
// elements by float4 atomics in the 16-byte slots they lie in (a slot's
// elements of the neighbouring rows add 0). PLANE and VOXEL_FACE have one
// slot, which every lane of the group computes, each keeping its own
// corners' cotangents.
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

// the slot's weight as K4 computes it, from what the forward pass parked:
// the truncated alpha (< 0: not contributing) and the transmittance (whose
// sign bit marks the median's hits)
HD float parked_weight(const BackRayParams& p, int64_t i) {
    const float at = p.d_alpha[i];
    if (at < 0.0f) return 0.0f;
    return fabsf(p.d_col[2 * (int64_t)p.S0 * p.M + i]) * (1.0f - one_minus(at));
}

// the first max-weight slot of entry e (K4's w_best), by the parked weights
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

// the weight of the ray's cache column k, its k-th contributing slot in
// walk order, from the cursor (entry e, slot s, n contributing slots
// before it) on; k increases from one call to the next
HD float column_weight(const BackRayParams& p, int64_t e1, int k, int64_t& e, int& s, int& n) {
    while (e < e1) {
        const int64_t i = (int64_t)s * p.M + e;
        if (++s == p.S0) {
            s = 0;
            ++e;
        }
        if (p.d_alpha[i] >= 0.0f && n++ == k) return parked_weight(p, i);
    }
    return 0.0f;
}

// the cotangent of t from the outputs that read every slot (kOut): the
// sample's t and the intersection's point (entry-major), through the ray's
// direction and grid2world's scale
HD float slot_dt_out(const BackRayOut& q, int64_t i, int64_t e, int s, int S0, const float dir[3]) {
    float dt = q.g_st ? q.g_st[i] : 0.0f;
    if (q.g_pts) {
        const float* gp = q.g_pts + 3 * (e * S0 + s);
        dt = dt + (gp[0] * dir[0] + gp[1] * dir[1] + gp[2] * dir[2]);
    }
    return dt;
}

#ifdef __CUDACC__
constexpr int kK5aBlock = 128;

// K4's one-sample picks and the cotangent each takes (kOut): the mode by
// either rule, the median, the sigma-thresh depth and the cache's median
struct RayPicks {
    float g_mode = 0.0f, g_med = 0.0f, g_sig = 0.0f, g_cmed = 0.0f;
    float wmax = 0.0f, t_mode = -INFINITY;  // the mode: its weight and (packed rule) t
    int64_t i_mode = -1;                    // the walks' rule: its slot
    float t_med = INFINITY, t_sig = INFINITY;
    int k_med = -1;                         // the cache median's column
};

// K5a on the card: ray r on G lanes, lane lg on its entries base + lg
template <bool kOut>
__global__ void __launch_bounds__(kK5aBlock) backward_ray_kernel(BackRayParams p, BackRayOut q) {
    constexpr int G = kK4Lanes;
    const int lane = threadIdx.x & 31, lg = lane & (G - 1);
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if ((gid - lane) / G >= p.B) return;  // the whole warp is past the last ray
    const int r = (int)(gid / G);
    const bool has_ray = r < p.B;
    const int rr = has_ray ? r : 0;  // the row of the per-ray inputs read
    const int64_t e0 = has_ray ? p.offsets[r] : 0, e1 = has_ray ? p.offsets[r + 1] : 0;
    const int64_t SM = (int64_t)p.S0 * p.M;
    const float ta = p.trunc_a[0];
    const float g_ld = p.g_rl[rr], g_lda = p.g_rl[p.B + rr];

    // forward, as K4: the same per-entry values through the same scans
    int cnt_c = 0, live_c = 0;  // counted and contributing (live) slots so far
    int64_t e_dead = e1;        // entries from here on were killed by stop_thresh
    float pre_c = 0.0f;         // log transmittance before the group (K4's log_T at the end)
    float W_c = 0.0f, WT_c = 0.0f, A_c = 0.0f, AT_c = 0.0f;  // l_dist's prefixes
    float t_ref = 0.0f;  // l_dist's origin of t: the ray's first contributing sample
    bool ref_set = false;
    // kOut, this lane's parts of K4's picks: its live weight sum (the
    // median's total), the mode (packed rule: weight, t and the entries
    // that hold both; walks' rule: weight, entry and slot of the first
    // maximum) and the sigma-thresh depth with its ties
    float lane_w = 0.0f, wm = 0.0f, tm = -INFINITY, wf = 0.0f, t_sig = INFINITY;
    int nm = 0, ef = INT32_MAX, n_sig = 0;
    int64_t i_f = -1;
    for (int64_t base = e0; __any_sync(kFullWarp, base < e1); base += G) {
        const int64_t e = base + lg;
        const bool valid = e < e1;
        int nc = 0;
        if (valid)
            for (int s = 0; s < p.S0; ++s) nc += p.counted[(int64_t)s * p.M + e];
        int cnt0 = cnt_c;
        if (p.truncated) {
            const int inc = warp_prefix<G>(nc, lg);
            cnt0 = cnt_c + warp_exclusive<G>(inc, lg);
            cnt_c = cnt_c + warp_total<G>(inc);
        }
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
        if (p.cache_K > 0) live_c = live_c + warp_allsum<G>(alive ? n_contrib : 0);

        // the entry's slots: the truncated alpha and the transmittance
        // parked, the weights as K4's, and W, WT, A, AT its l_dist sums
        float W = 0.0f, WT = 0.0f, A = 0.0f, AT = 0.0f;
        if (valid) {
            float local = 0.0f;  // the log attenuation of the entry's slots so far
            float w_best = -1.0f, t_best = 0.0f;
            int c = cnt0;
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                const bool ct = alive && p.contrib[i];
                const float ac = ct ? alpha_trunc(p, i, c, ta) : 0.0f;
                c += p.counted[i];
                const float om = ct ? one_minus(ac) : 1.0f;
                const float T = expf(fminf(e_pre + local, 0.0f));
                const float w = ct ? T * (1.0f - om) : 0.0f;
                local = local + logf(om);
                p.d_alpha[i] = ct ? ac : -1.0f;
                p.d_col[2 * SM + i] = T;
                const float t = p.t[i];
                if constexpr (kOut) {
                    if (w > w_best) {  // the entry's first max-weight slot
                        w_best = w;
                        t_best = t;
                    }
                    if (q.mode_first && w > wf) {  // the lane's first max-weight slot
                        wf = w;
                        ef = (int)(e - e0);
                        i_f = i;
                    }
                }
                if (!ct) continue;
                if constexpr (kOut) {
                    lane_w = lane_w + w;
                    if (!p.fake[i] && p.alpha[i] > q.sig_thresh) {
                        if (t < t_sig) {
                            t_sig = t;
                            n_sig = 1;
                        } else if (t == t_sig) {
                            ++n_sig;
                        }
                    }
                }
                if (!(p.fake_l_dist || !p.fake[i])) continue;
                const float ts = t - t_ref;
                W = W + w;
                WT = WT + w * ts;
                A = A + ac;
                AT = AT + ac * ts;
            }
            if constexpr (kOut) {
                if (q.mode_first) {
                } else if (w_best > wm) {
                    wm = w_best;
                    tm = t_best;
                    nm = 1;
                } else if (w_best == wm && w_best > 0.0f) {
                    if (t_best > tm) {
                        tm = t_best;
                        nm = 1;
                    } else if (t_best == tm) {
                        ++nm;
                    }
                }
            }
        }
        // l_dist's prefix parts: the sums over the slots before each one
        const float W_inc = warp_prefix<G>(W, lg), WT_inc = warp_prefix<G>(WT, lg);
        const float A_inc = warp_prefix<G>(A, lg), AT_inc = warp_prefix<G>(AT, lg);
        float Aw = W_c + warp_exclusive<G>(W_inc, lg), Sw = WT_c + warp_exclusive<G>(WT_inc, lg);
        float Aa = A_c + warp_exclusive<G>(A_inc, lg), Sa = AT_c + warp_exclusive<G>(AT_inc, lg);
        W_c = W_c + warp_total<G>(W_inc);
        WT_c = WT_c + warp_total<G>(WT_inc);
        A_c = A_c + warp_total<G>(A_inc);
        AT_c = AT_c + warp_total<G>(AT_inc);
        if (valid) {
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                const float at = p.d_alpha[i];
                if (at < 0.0f) continue;
                if (!(p.fake_l_dist || !p.fake[i])) {
                    p.d_t[i] = 0.0f;
                    continue;
                }
                const float w = parked_weight(p, i);
                const float ts = p.t[i] - t_ref;
                p.d_t[i] = g_ld * w * Aw + g_lda * at * Aa;
                p.d_col[i] = g_ld * (ts * Aw - Sw);
                p.d_col[SM + i] = g_lda * (ts * Aa - Sa);
                Aw = Aw + w;
                Sw = Sw + w * ts;
                Aa = Aa + at;
                Sa = Sa + at * ts;
            }
        }
    }

    // K4's picks, reduced over the ray's lanes
    RayPicks k;
    float gd = 0.0f, gn[3] = {0.0f, 0.0f, 0.0f}, dir[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kOut) {
#pragma unroll
        for (int d = G / 2; d > 0; d >>= 1) {
            const float w2 = __shfl_xor_sync(kFullWarp, wm, d, G);
            const float t2 = __shfl_xor_sync(kFullWarp, tm, d, G);
            const int n2 = __shfl_xor_sync(kFullWarp, nm, d, G);
            if (w2 > wm) {
                wm = w2;
                tm = t2;
                nm = n2;
            } else if (w2 == wm) {
                if (t2 > tm) {
                    tm = t2;
                    nm = n2;
                } else if (t2 == tm) {
                    nm += n2;
                }
            }
            const float wf2 = __shfl_xor_sync(kFullWarp, wf, d, G);
            const int ef2 = __shfl_xor_sync(kFullWarp, ef, d, G);
            const int64_t if2 = __shfl_xor_sync(kFullWarp, i_f, d, G);
            if (wf2 > wf || (wf2 == wf && ef2 < ef)) {
                wf = wf2;
                ef = ef2;
                i_f = if2;
            }
            const float ts2 = __shfl_xor_sync(kFullWarp, t_sig, d, G);
            const int ns2 = __shfl_xor_sync(kFullWarp, n_sig, d, G);
            if (ts2 < t_sig) {
                t_sig = ts2;
                n_sig = ns2;
            } else if (ts2 == t_sig) {
                n_sig += ns2;
            }
        }
        k.wmax = q.mode_first ? wf : wm;
        k.t_mode = tm;
        k.i_mode = i_f;
        k.t_sig = t_sig;
        if (q.g_mode && has_ray && k.wmax > 0.0f) k.g_mode = q.g_mode[r] / (q.mode_first ? 1 : nm);
        if (q.g_sig && has_ray && n_sig > 0) k.g_sig = q.g_sig[r] / n_sig;
        // the median, by K4's sweep over the live entries' weights: each
        // hit of its test marked in its parked transmittance's sign bit
        if (q.g_med) {
            const float totW = warp_allsum<G>(lane_w);
            const float thr = 0.5f * totW;
            const int64_t e_end = totW > 1e-12f ? e_dead : e0;
            float preW_c = 0.0f, t_med = INFINITY;
            int n_med = 0;
            for (int64_t base = e0; __any_sync(kFullWarp, base < e_end); base += G) {
                const int64_t e = base + lg;
                const bool valid = e < e_end;
                float ws = 0.0f;
                if (valid)
                    for (int s = 0; s < p.S0; ++s) ws = ws + parked_weight(p, (int64_t)s * p.M + e);
                const float inc = warp_prefix<G>(ws, lg);
                float pw = preW_c + warp_exclusive<G>(inc, lg);
                if (valid) {
                    for (int s = 0; s < p.S0; ++s) {
                        const int64_t i = (int64_t)s * p.M + e;
                        const float w = parked_weight(p, i);
                        if (p.contrib[i] && pw + w >= thr) {
                            p.d_col[2 * SM + i] = -p.d_col[2 * SM + i];
                            const float t = p.t[i];
                            if (t < t_med) {
                                t_med = t;
                                n_med = 1;
                            } else if (t == t_med) {
                                ++n_med;
                            }
                        }
                        pw = pw + w;
                    }
                }
                preW_c = preW_c + warp_total<G>(inc);
            }
#pragma unroll
            for (int d = G / 2; d > 0; d >>= 1) {
                const float t2 = __shfl_xor_sync(kFullWarp, t_med, d, G);
                const int n2 = __shfl_xor_sync(kFullWarp, n_med, d, G);
                if (t2 < t_med) {
                    t_med = t2;
                    n_med = n2;
                } else if (t2 == t_med) {
                    n_med += n2;
                }
            }
            k.t_med = t_med;
            if (has_ray && n_med > 0) k.g_med = q.g_med[r] / n_med;
        }
        // the cache's median, by K4's sums over its columns in K4's groups
        if (q.g_cmed && p.cache_K > 0) {
            const int n_cached = min(live_c, p.cache_K);
            __syncwarp();  // the parked slots other lanes of the ray wrote
            int64_t ce = e0;
            int cs = 0, cn = 0;
            float tot = 0.0f;
            for (int k0 = 0; k0 < p.cache_K; k0 += G) {
                const int kk = k0 + lg;
                tot = tot + warp_allsum<G>(kk < n_cached ? column_weight(p, e1, kk, ce, cs, cn)
                                                         : 0.0f);
            }
            const float thr = fmaxf(0.5f * tot, 1e-12f);
            ce = e0;
            cs = cn = 0;
            float cum = 0.0f;
            int hit = -1;
            for (int k0 = 0; k0 < p.cache_K; k0 += G) {
                const int kk = k0 + lg;
                const bool in = kk < n_cached;
                const float inc = warp_prefix<G>(in ? column_weight(p, e1, kk, ce, cs, cn) : 0.0f,
                                                 lg);
                const unsigned h =
                    segment_bits<G>(__ballot_sync(kFullWarp, in && cum + inc >= thr), lane);
                if (hit < 0 && h) hit = k0 + __ffs(h) - 1;
                cum = cum + warp_total<G>(inc);
            }
            k.k_med = tot > 0.0f && hit >= 0 ? hit : -1;
            if (has_ray && k.k_med >= 0) k.g_cmed = q.g_cmed[r];
        }
        if (has_ray) {
            if (q.g_depth) gd = q.g_depth[r];
            if (q.g_normal)
                for (int c = 0; c < 3; ++c) gn[c] = q.g_normal[3 * (int64_t)r + c];
            if (q.g_pts)
                for (int c = 0; c < 3; ++c) dir[c] = q.dirs[3 * (int64_t)r + c] * q.rscale[c];
        }
    }

    // backward: the groups from the ray's last to its first; every suffix
    // quantity is the entry's own plus an exclusive suffix over the later
    // lanes, carried from the later groups
    const float g_ent = p.g_rl[2 * p.B + rr], g_enta = p.g_rl[3 * p.B + rr];
    const float g_sls = p.g_rl[4 * p.B + rr], g_slsw = p.g_rl[5 * p.B + rr];
    const float Gc[3] = {p.g_rgb[3 * (int64_t)rr], p.g_rgb[3 * (int64_t)rr + 1],
                         p.g_rgb[3 * (int64_t)rr + 2]};
    const float* bgc = p.bg_rgb ? p.bg_rgb + 3 * (int64_t)rr : nullptr;
    // Sigma after the group: the background's term (log_T's cotangent too)
    // plus Wbar w of every later slot
    float Sig_c = (bgc ? Gc[0] * bgc[0] + Gc[1] * bgc[1] + Gc[2] * bgc[2]
                       : p.bg * (Gc[0] + Gc[1] + Gc[2])) * expf(pre_c);
    if constexpr (kOut) {
        if (q.g_log_T && has_ray) Sig_c = Sig_c + q.g_log_T[r];
    }
    float Aw_c = 0.0f, Sw_c = 0.0f, Aa_c = 0.0f, Sa_c = 0.0f;  // l_dist's sums after the group
    int cnt_hi = cnt_c, live_hi = live_c;  // counted and live slots before the group's end
    const int64_t last = e1 > e0 ? e0 + (e1 - 1 - e0) / G * G : e0 - G;
    for (int64_t base = last; __any_sync(kFullWarp, base >= e0); base -= G) {
        const int64_t e = base + lg;
        const bool valid = base >= e0 && e < e1;
        // the entry's counted and live slots and its l_dist sums
        int nc = 0, nl = 0;
        float W = 0.0f, WT = 0.0f, A = 0.0f, AT = 0.0f;
        if (valid) {
            for (int s = 0; s < p.S0; ++s) {
                const int64_t i = (int64_t)s * p.M + e;
                nc += p.counted[i];
                const float at = p.d_alpha[i];
                if (at < 0.0f) continue;
                ++nl;
                if (!(p.fake_l_dist || !p.fake[i])) continue;
                const float w = parked_weight(p, i);
                const float ts = p.t[i] - t_ref;
                W = W + w;
                WT = WT + w * ts;
                A = A + at;
                AT = AT + at * ts;
            }
        }
        int cnt0 = 0, live0 = 0;  // before the entry: the totals less the suffix scans
        if (p.truncated) {
            const int suf = warp_suffix<G>(nc, lg);
            cnt0 = cnt_hi - suf;
            cnt_hi = cnt_hi - warp_suffix_total<G>(suf);
        }
        if (p.cache_K > 0) {
            const int suf = warp_suffix<G>(nl, lg);
            live0 = live_hi - suf;
            live_hi = live_hi - warp_suffix_total<G>(suf);
        }
        const float W_suf = warp_suffix<G>(W, lg), WT_suf = warp_suffix<G>(WT, lg);
        const float A_suf = warp_suffix<G>(A, lg), AT_suf = warp_suffix<G>(AT, lg);
        float Aw = Aw_c + warp_exclusive_suffix<G>(W_suf, lg);
        float Sw = Sw_c + warp_exclusive_suffix<G>(WT_suf, lg);
        float Aa = Aa_c + warp_exclusive_suffix<G>(A_suf, lg);
        float Sa = Sa_c + warp_exclusive_suffix<G>(AT_suf, lg);
        Aw_c = Aw_c + warp_suffix_total<G>(W_suf);
        Sw_c = Sw_c + warp_suffix_total<G>(WT_suf);
        Aa_c = Aa_c + warp_suffix_total<G>(A_suf);
        Sa_c = Sa_c + warp_suffix_total<G>(AT_suf);

        // each live slot's Wbar (d loss / d w), abar (d loss / d truncated
        // alpha) and d t, from the last slot down (Aw, Sw, Aa, Sa: over the
        // slots after it); X, the entry's sum of Wbar w
        float X = 0.0f;
        if (valid) {
            int s_best = -1;  // the mode's slot here, packed rule
            if constexpr (kOut) {
                if (k.g_mode != 0.0f && !q.mode_first) {
                    float w_best;
                    const int sb = entry_best(p, e, w_best);
                    if (w_best == k.wmax && w_best > 0.0f && p.t[(int64_t)sb * p.M + e] == k.t_mode)
                        s_best = sb;
                }
            }
            int kc = live0 + nl;  // the slot's cache column, counted down
            for (int s = p.S0 - 1; s >= 0; --s) {
                const int64_t i = (int64_t)s * p.M + e;
                const float at = p.d_alpha[i];
                if (at < 0.0f) continue;
                const float Tm = p.d_col[2 * SM + i];
                const float T = fabsf(Tm);
                const float om = one_minus(at);
                const float w = T * (1.0f - om);
                const bool inc = p.fake_l_dist || !p.fake[i];
                const float wi = inc ? w : 0.0f, a = inc ? at : 0.0f;
                const float t = p.t[i];
                const float ts = t - t_ref;
                float Wbar = Gc[0] * p.rgb[i];
                Wbar = Wbar + Gc[1] * p.rgb[SM + i];
                Wbar = Wbar + Gc[2] * p.rgb[2 * SM + i];
                float abar = (g_sls + g_slsw * w) * logsig_grad(at);
                float dt = p.d_t[i];
                if (inc) {
                    Wbar = Wbar + p.d_col[i] + g_ld * (Sw - ts * Aw);
                    if (wi > 0.0f) Wbar = Wbar + g_ent * entropy_grad(wi);
                    abar = abar + p.d_col[SM + i] + g_lda * (Sa - ts * Aa);
                    if (a > 0.0f) abar = abar + g_enta * entropy_grad(a);
                    dt = dt - g_ld * wi * Aw - g_lda * a * Aa;
                }
                --kc;
                if (p.g_cts && kc < p.cache_K) {
                    const int64_t ck = (int64_t)r * p.cache_K + kc;
                    Wbar = Wbar + p.g_cw[ck];
                    abar = abar + p.g_calpha[ck];
                    dt = dt + p.g_cts[ck];
                }
                if constexpr (kOut) {
                    // depth = sum w t; normal = sum w n
                    Wbar = Wbar + gd * t;
                    dt = dt + gd * w + slot_dt_out(q, i, e, s, p.S0, dir);
                    if (q.g_normal) {
                        const float* sn = q.snorm + i;
                        Wbar = Wbar + (gn[0] * sn[0] + gn[1] * sn[SM] + gn[2] * sn[2 * SM]);
                    }
                    if (q.g_sw) Wbar = Wbar + q.g_sw[i];
                    if (q.g_sac) abar = abar + q.g_sac[i];
                    // the depths that pick one sample (or split over tied ones)
                    if (k.g_mode != 0.0f && (q.mode_first ? i == k.i_mode : s == s_best))
                        dt = dt + k.g_mode;
                    if (k.g_med != 0.0f && signbit(Tm) && t == k.t_med) dt = dt + k.g_med;
                    if (k.g_sig != 0.0f && !p.fake[i] && p.alpha[i] > q.sig_thresh && t == k.t_sig)
                        dt = dt + k.g_sig;
                    if (k.g_cmed != 0.0f && kc == k.k_med) dt = dt + k.g_cmed;
                }
                p.d_col[i] = Wbar;
                p.d_col[SM + i] = abar;
                p.d_t[i] = dt;
                X = X + Wbar * w;
                Aw = Aw + wi;
                Sw = Sw + wi * ts;
                Aa = Aa + a;
                Sa = Sa + a * ts;
            }
        }
        const float X_suf = warp_suffix<G>(X, lg);
        const float Sig_e = Sig_c + warp_exclusive_suffix<G>(X_suf, lg);  // after the entry
        Sig_c = Sig_c + warp_suffix_total<G>(X_suf);

        // the cotangents of the pre-truncation alphas and the colours
        if (valid) {
            float Sig_l = 0.0f;  // Wbar w over the entry's later slots
            int c = cnt0 + nc;   // the truncation index, counted down
            for (int s = p.S0 - 1; s >= 0; --s) {
                const int64_t i = (int64_t)s * p.M + e;
                c -= p.counted[i];
                const float at = p.d_alpha[i];
                if (at < 0.0f) {  // not contributing
                    p.d_alpha[i] = 0.0f;
                    p.d_t[i] = 0.0f;
                    for (int ch = 0; ch < 3; ++ch) p.d_col[ch * SM + i] = 0.0f;
                    if constexpr (kOut) {
                        if (q.g_sa) p.d_alpha[i] = q.g_sa[i];
                        p.d_t[i] = slot_dt_out(q, i, e, s, p.S0, dir);
                        if (q.d_snorm)
                            for (int ch = 0; ch < 3; ++ch) q.d_snorm[ch * SM + i] = 0.0f;
                    }
                    continue;
                }
                const float T = fabsf(p.d_col[2 * SM + i]);
                const float om = one_minus(at);
                const float w = T * (1.0f - om);
                const float Wbar = p.d_col[i], abar = p.d_col[SM + i];
                const float d_om = -T * Wbar + (Sig_e + Sig_l) / om;
                const float d_at = abar - d_om * clip_grad(1.0f - at, 1e-7f, 1.0f - 1e-7f);
                const float rw = p.truncated ? trunc_rw(c - (p.fake[i] ? 1 : 0), ta, p.trunc_wmin)
                                             : 1.0f;
                float d_sa = 0.0f;
                if constexpr (kOut) {
                    if (q.g_sa) d_sa = q.g_sa[i];
                    if (q.g_normal)
                        for (int ch = 0; ch < 3; ++ch) q.d_snorm[ch * SM + i] = gn[ch] * w;
                }
                p.d_alpha[i] = kOut ? d_at * rw + d_sa : d_at * rw;
                for (int ch = 0; ch < 3; ++ch) p.d_col[ch * SM + i] = Gc[ch] * w;
                Sig_l = Sig_l + Wbar * w;
            }
        }
    }
}
#endif

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
// corner alphas unless the alpha comes from UDF_ALPHA's table, kTable) and
// the colours' (into dC). Returns the cotangent of the slot's t: d_t plus
// that of the sample position, which moves with t. kNormal: the rendered
// normal's cotangent too, into the corner surface values (dS8) and the
// position through the field's gradient, or for PLANE (plane_abc, its mean
// plane's normal) into dP's a, b, c.
template <bool kNormal, bool kTable>
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
        if (!kTable) dA8[c] = dA8[c] + draw * s.w8[c];
        dw8[c] = kTable ? 0.0f : draw * cs.alpha8[c];
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

// The fake sample's cotangents (scalar fields): into the corner alphas (or
// UDF_ALPHA's table), the corner surface values through its normalised
// value and the corners' std, and the colours. Returns this entry's part
// of the fake_sample_std gradient.
template <bool kTable>
HD float fake_slot_vjp(const BackEntryParams& p, const Corners& cs, const float o[3],
                       const float d[3], const int l[3], float close_t, float far_t,
                       bool vox_has_sample, bool vox_has_surf, int64_t m, float g_in, float g_lap,
                       float dA8[8], float dS8[8], float dC[3][8], float* gtab) {
    const int64_t SM = (int64_t)p.S0 * p.M;
    const float fss = p.fs_std ? p.fs_std[0] : 1.0f;
    FakeSlot fk;
    fake_slot(cs, o, d, l, close_t, far_t, vox_has_sample, vox_has_surf, p.min_vox_len,
              p.limited_fake, p.normalize_surf, p.level_sets, p.n_lv, p.sigma_thresh, fss,
              p.act_sigmoid, p.lv_alpha, fk);
    const int64_t k = (int64_t)(p.S0 - 1) * p.M + m;
    float da = p.d_alpha[k];
    if (p.contrib[k]) da = da + g_in * inward_sq(fk.fsn, d) + g_lap * lap_grad(fk.falpha);
    const float dcol[3] = {p.d_col[k], p.d_col[SM + k], p.d_col[2 * SM + k]};
    if (da == 0.0f && dcol[0] == 0.0f && dcol[1] == 0.0f && dcol[2] == 0.0f) return 0.0f;
    // falpha = alpha_act(fraw) * exp(-q^2 / 2), q = fake_dist / fss
    const float draw = da * fk.gauss * alpha_act_grad(fk.fraw, p.act_sigmoid);
    if (kTable)
        add_table(p, gtab, fk.amin, draw);
    else
        for (int c = 0; c < 8; ++c) dA8[c] = dA8[c] + draw * fk.fw8[c];
    const float dq = da * fk.base * (fk.gauss * -fk.q);
    const float g_fss = dq * (-fk.q / fss);
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
    return g_fss;
}

#ifdef __CUDACC__
constexpr int kK5bBlock = 128;

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

// The reduce-scatter of a group of kK3Lanes = 4 lanes: own[k] the sum over
// the group of v[lg + 4 k], the lane's own corners. Two butterfly steps:
// lanes 2 apart swap the half of the corners the other keeps (c & 2 its
// bit 1 of lg), then lanes 1 apart (c & 1 its bit 0). The indices are
// compile-time, so v stays in registers.
__device__ __forceinline__ void corner_reduce_scatter(const float v[8], int lg, float own[2]) {
    const bool b1 = (lg >> 1) & 1, b0 = lg & 1;
    float h[4];  // corners lo(t) | (b1 << 1), lo(t) = 0, 1, 4, 5: bit 1 clear
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int lo = (t & 1) | ((t >> 1) << 2);
        const float mine = b1 ? v[lo | 2] : v[lo];
        const float give = b1 ? v[lo] : v[lo | 2];
        h[t] = mine + __shfl_xor_sync(kFullWarp, give, 2, kK3Lanes);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // h[2 u] and h[2 u + 1]: corners 4 u + (b1 << 1) + 0 / 1
        const float mine = b0 ? h[2 * u + 1] : h[2 * u];
        const float give = b0 ? h[2 * u] : h[2 * u + 1];
        own[u] = mine + __shfl_xor_sync(kFullWarp, give, 1, kK3Lanes);
    }
}

// own[k] = v[lg + 4 k], the lane's own corners of a value every lane holds
__device__ __forceinline__ void own_corners(const float v[8], int lg, float own[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
        own[k] = lg == 0 ? v[4 * k]
                 : lg == 1 ? v[4 * k + 1]
                 : lg == 2 ? v[4 * k + 2]
                           : v[4 * k + 3];
}

// the gradient of SH row `row`, g[ch] shm[b] at element ch bd + b, added by
// float4 atomics in the 16-byte slots of g_sh (n_sh floats) the row's 3 bd
// elements lie in (the elements of the rows beside it in a slot add 0; a
// slot past the end adds element by element)
template <int kBd>
__device__ __forceinline__ void add_sh_row(float* g_sh, int64_t n_sh, int64_t row, int bd_rt,
                                           const float* shm, const float g[3]) {
    const int bd = kBd > 0 ? kBd : bd_rt, nsh = 3 * bd;
    const int64_t e_row = row * nsh;
    const int ph = (int)(e_row & 3);
    const int n_slots = (ph + nsh + 3) >> 2;
    for (int qs = 0; qs < n_slots; ++qs) {
        const int64_t a = e_row - ph + 4 * qs;
        float x[4];
        bool any = false;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int j = 4 * qs + t - ph;
            float v = 0.0f;
            if (j >= 0 && j < nsh) {
                const int ch = j / bd, b = j - ch * bd;
                v = (ch == 0 ? g[0] : (ch == 1 ? g[1] : g[2])) * __ldg(shm + b);
            }
            x[t] = v;
            any = any || v != 0.0f;
        }
        if (any && a + 4 <= n_sh) {
            atomicAdd(reinterpret_cast<float4*>(g_sh + a), make_float4(x[0], x[1], x[2], x[3]));
        } else if (any) {
            for (int t = 0; t < 4; ++t)
                if (x[t] != 0.0f) atomicAdd(g_sh + a + t, x[t]);
        }
    }
}

// K5b on the card: entry m on kK3Lanes lanes (a warp holds 8 entries)
template <int kType, int kBd, bool kShMult, bool kNormal>
__global__ void __launch_bounds__(kK5bBlock) backward_entry_kernel(BackEntryParams p) {
    constexpr int G = kK3Lanes;
    constexpr bool kOneSlot = kType == SURF_PLANE || kType == SURF_VOXEL_FACE;
    constexpr bool kTable = kType == SURF_UDF_ALPHA;
    constexpr bool kUdf = kType == SURF_UDF || kTable || kType == SURF_UDF_FAKE_SAMPLE;
    const int lane = threadIdx.x & 31, lg = lane & (G - 1);
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if ((gid - lane) / G >= p.M) return;  // the whole warp is past the last entry
    // a group past the last entry works on it and adds nothing
    const bool valid = gid / G < p.M;
    const int64_t m = valid ? gid / G : p.M - 1;
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
    int own_link[2];
    float own_sraw[2];
    gather_corners_lanes<kType, kBd>(p, shm, l, lane, cs, pl, own_link,
                                     kUdf ? own_sraw : nullptr);
    const bool active = valid && cs.vox_ok;  // else no slot of the entry contributes

    const int64_t SM = (int64_t)p.S0 * p.M;
    const bool in_win = !p.win || p.win[m];
    const float g_in = in_win ? p.g_rl[7 * p.B + r] : 0.0f;
    const float g_lap = in_win ? p.g_rl[8 * p.B + r] : 0.0f;
    float gtab[kTable ? MAX_LV_TABLE : 1];  // UDF_ALPHA's level-set alpha cotangents
    const int n_tab = kTable ? min(p.n_lv, MAX_LV_TABLE) : 0;
    for (int i = 0; i < n_tab; ++i) gtab[i] = 0.0f;
    float g_fss = 0.0f;
    // the sums of the lane's own two corners: density, surface, colour
    float oA[2], oS[2], oC[3][2];
    float dP[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // PLANE's mean plane
    float dA8[8], dS8[8], dC[3][8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        dA8[c] = dS8[c] = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) dC[ch][c] = 0.0f;
    }

    if constexpr (kOneSlot) {
        // one slot, which every lane of the group computes
        if (active) {
            if constexpr (kType == SURF_VOXEL_FACE) {
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
            } else {
                PlaneRoot q;
                plane_root(pl, o, d, l, q);
                RealSlot s;
                real_slot(cs, o, d, l, close_t, q.t_pl - close_t, cs.vox_ok && q.t_pl > 0.0f,
                          p.near_grid_t, p.only_outward, q.abc, s);
                float draw;
                const float dt = real_slot_vjp<kNormal, false>(p, cs, s, m, d, g_in, g_lap, dA8,
                                                              dC, draw, dS8, q.abc, dP);
                // t = close_t + (t_pl - close_t): its cotangent is t_pl's
                if (dt != 0.0f) plane_root_vjp(q, pl[3], o, d, l, dt, dP);
            }
        }
        own_corners(dA8, lg, oA);
        own_corners(dS8, lg, oS);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) own_corners(dC[ch], lg, oC[ch]);
    } else {
        float smin = cs.surf8[0], smax = cs.surf8[0];
        for (int c = 1; c < 8; ++c) {
            smin = fminf(smin, cs.surf8[c]);
            smax = fmaxf(smax, cs.surf8[c]);
        }
        float u[3], f[4];
        for (int a = 0; a < 3; ++a) u[a] = o[a] + close_t * d[a] - (float)l[a];
        cubic_coeffs(cs.surf8, u, d, f);

        // lane j: slot j = root j mod 3 of level set j / 3 (and j + G, ...)
        float df[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the cubic's coefficients
        const int n_real = 3 * p.n_lv;
        bool has_sample = false, has_surf = false;
        int n_lv_hull = 0;
        for (int j0 = 0; j0 < n_real; j0 += G) {
            const int j = j0 + lg;
            const bool mine = j < n_real;
            const int i = mine ? j / 3 : 0;
            const int jr = j - 3 * i;
            const float lv = p.level_sets[i];
            const bool lv_ok = cs.vox_ok && lv >= smin && lv <= smax;
            bool has;
            const float root = cubic_root(f[0] - lv, f[1], f[2], f[3], jr, has);
            RealSlot s;
            real_slot(cs, o, d, l, close_t, root, lv_ok, p.near_grid_t, p.only_outward, nullptr, s);
            if (kTable) s.raw = p.lv_alpha[i];  // the level set's alpha
            has_sample = has_sample || (mine && s.geo_pre);
            has_surf = has_surf || (mine && lv_ok);
            n_lv_hull += mine && jr == 0 && lv_ok ? 1 : 0;
            if (!(mine && active)) continue;
            float draw;
            const float dt = real_slot_vjp<kNormal, kTable>(p, cs, s, (int64_t)j * p.M + m, d, g_in,
                                                            g_lap, dA8, dC, draw, dS8, nullptr, dP);
            if (kTable) add_table(p, gtab, i, draw);
            // t = close_t + root; the root moves with the coefficients
            if (has && dt != 0.0f) {
                const float ts = root;
                const float fp = 3.0f * f[3] * ts * ts + 2.0f * f[2] * ts + f[1];
                const float gt = -dt / safe_fp(fp);
                df[0] = df[0] + gt;
                df[1] = df[1] + gt * ts;
                df[2] = df[2] + gt * ts * ts;
                df[3] = df[3] + gt * ts * ts * ts;
            }
        }
        has_sample = segment_bits<G>(__ballot_sync(kFullWarp, has_sample), lane) != 0u;
        has_surf = segment_bits<G>(__ballot_sync(kFullWarp, has_surf), lane) != 0u;
        n_lv_hull = warp_allsum<G>(n_lv_hull);
        if (p.fake_sample && active && lg == (p.S0 - 1) % G)  // slot S0 - 1's lane
            g_fss = fake_slot_vjp<kTable>(p, cs, o, d, l, close_t, far_t, has_sample, has_surf, m,
                                          g_in, g_lap, dA8, dS8, dC, gtab);
        corner_reduce_scatter(dA8, lg, oA);
        corner_reduce_scatter(dS8, lg, oS);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) corner_reduce_scatter(dC[ch], lg, oC[ch]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) df[kk] = warp_allsum<G>(df[kk]);
        if (active) {
            if (df[0] != 0.0f || df[1] != 0.0f || df[2] != 0.0f || df[3] != 0.0f) {
                // the coefficients are linear in the corner values: f(e_c) is d f / d s_c
                for (int k = 0; k < 2; ++k) {
                    const int c = lg + 4 * k;
                    float e[8], fc[4];
                    for (int kk = 0; kk < 8; ++kk) e[kk] = kk == c ? 1.0f : 0.0f;
                    cubic_coeffs(e, u, d, fc);
                    oS[k] = oS[k] + df[0] * fc[0] + df[1] * fc[1] + df[2] * fc[2] + df[3] * fc[3];
                }
            }
            if constexpr (kUdf) {
                // the udf-var term: factor * sum_c (s_c - mu)^2 / 7
                const float g_udf = in_win ? p.g_rl[10 * p.B + r] : 0.0f;
                const float kf = udf_hull_factor(kType, n_lv_hull, p.n_lv, p.fake_sample,
                                                 p.limited_fake);
                const float gv = g_udf * kf / 7.0f;
                if (gv != 0.0f) {
                    float mu;
                    udf_var(cs.surf8, mu);
                    float dmu = 0.0f;
                    for (int c = 0; c < 8; ++c) dmu = dmu - gv * (2.0f * (cs.surf8[c] - mu));
                    for (int k = 0; k < 2; ++k)
                        oS[k] = oS[k] + gv * (2.0f * (cs.surf8[lg + 4 * k] - mu)) + dmu / 8.0f;
                }
                // the corner values are softplus of the rows
                for (int k = 0; k < 2; ++k)
                    if (oS[k] != 0.0f) oS[k] = oS[k] * softplus_grad(own_sraw[k]);
            }
        }
    }

    // the lane's two corner rows
    if (active) {
        const int64_t n_sh = (int64_t)p.cap * 3 * p.bd;
        for (int k = 0; k < 2; ++k) {
            const int64_t row = own_link[k];  // present: vox_ok holds
            if (!kTable && oA[k] != 0.0f) atomicAdd(p.g_density + row, oA[k]);
            if constexpr (kType == SURF_PLANE) {
                for (int kk = 0; kk < 4; ++kk) {
                    const float v = dP[kk] / 8.0f;  // the mean's share of each corner
                    if (v != 0.0f) atomicAdd(p.g_surface + row * p.n_surf_c + kk, v);
                }
            } else if (oS[k] != 0.0f) {
                atomicAdd(p.g_surface + row * p.n_surf_c, oS[k]);
            }
            const float gc[3] = {oC[0][k], oC[1][k], oC[2][k]};
            add_sh_row<kBd>(p.g_sh, n_sh, row, p.bd, shm, gc);
        }
    }
    const float gf = warp_sum(g_fss);
    if (lane == 0 && gf != 0.0f && p.g_fss) atomicAdd(p.g_fss, gf);
    if constexpr (kTable) {
        // every entry adds to the few rows of the table: one atomic a warp and row
        for (int i = 0; i < n_tab; ++i) {
            const float v = warp_sum(gtab[i]);
            if (lane == 0 && v != 0.0f) atomicAdd(p.g_density + i, v);
        }
    }
    if constexpr (kShMult) {
        // g_sh_mult[r, b]: the lane's corners' colour cotangents contracted
        // with their rows, summed over the ray's lanes in the warp; every
        // lane takes part in the shuffles, the tail's (key -1) too
        const int key = valid ? r : -1;
        const int r_prev = __shfl_up_sync(kFullWarp, key, 1);
        const bool first = lane == 0 || r_prev != key;
        const int sh_base = 1 + p.n_surf_c;
        for (int b = 0; b < p.bd; ++b) {
            float acc = 0.0f;
            if (active) {
                for (int k = 0; k < 2; ++k) {
                    const float* row = p.packed + (int64_t)own_link[k] * p.C8 + sh_base;
                    for (int ch = 0; ch < 3; ++ch) acc = acc + oC[ch][k] * row[ch * p.bd + b];
                }
            }
            const float v = segment_sum(acc, key);
            if (first && key >= 0 && v != 0.0f) atomicAdd(p.g_sh_mult + (int64_t)r * p.bd + b, v);
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
    const int64_t threads = (int64_t)B * kK4Lanes;
    const unsigned grid = (unsigned)((threads + kK5aBlock - 1) / kK5aBlock);
    const cudaStream_t s = (cudaStream_t)stream;
    if (out) {
        if (!out->snorm || (out->g_normal != nullptr) != (out->d_snorm != nullptr))
            return cudaErrorInvalidValue;
        backward_ray_kernel<true><<<grid, kK5aBlock, 0, s>>>(p, *out);
    } else {
        backward_ray_kernel<false><<<grid, kK5aBlock, 0, s>>>(p, BackRayOut{});
    }
    return cudaGetLastError();
}

// rows of basis_dim 9 (SH), laid out at compile time, as K3's
constexpr int kK5bFixedBd = 9;

template <int kType, bool kShMult, bool kNormal>
void launch_entry(const BackEntryParams& p, unsigned grid, cudaStream_t stream) {
    constexpr int kShBase = 1 + (kType == SURF_PLANE ? 4 : 1);
    constexpr int kC8 = (kShBase + 3 * kK5bFixedBd + 7) / 8 * 8;
    if (p.bd == kK5bFixedBd && p.C8 == kC8 && p.n_surf_c == kShBase - 1)
        backward_entry_kernel<kType, kK5bFixedBd, kShMult, kNormal>
            <<<grid, kK5bBlock, 0, stream>>>(p);
    else
        backward_entry_kernel<kType, 0, kShMult, kNormal><<<grid, kK5bBlock, 0, stream>>>(p);
}

// the launcher of every K5b instantiation: d_snorm null for the rgb-only
// one, the normal's cotangent for the second (VOXEL_FACE's normal is 0:
// it has no second)
template <int kType>
cudaError_t launch_backward_entry(const BackEntryParams& p, cudaStream_t stream) {
    const int64_t threads = p.M * kK3Lanes;
    const unsigned grid = (unsigned)((threads + kK5bBlock - 1) / kK5bBlock);
    constexpr bool kHasNormal = kType != SURF_VOXEL_FACE;
    if (kHasNormal && p.d_snorm) {
        if constexpr (kHasNormal) {
            if (p.g_sh_mult)
                launch_entry<kType, true, true>(p, grid, stream);
            else
                launch_entry<kType, false, true>(p, grid, stream);
        }
    } else if (p.g_sh_mult) {
        launch_entry<kType, true, false>(p, grid, stream);
    } else {
        launch_entry<kType, false, false>(p, grid, stream);
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
    if (M <= 0) return cudaSuccess;
    // the rows are read in 16-byte loads, the SH gradient added in float4s
    if ((reinterpret_cast<uintptr_t>(packed) & 15u) != 0u || C8 % 4 != 0 ||
        (reinterpret_cast<uintptr_t>(g_sh) & 15u) != 0u)
        return cudaErrorMisalignedAddress;
    const BackEntryParams p{ray_id, l, close_t, far_t, M, B, origins, dirs, sh_mult, bd, links,
                            X, Y, Z, packed, cap, C8, n_surf_c, level_sets, n_lv, S0, stype,
                            lv_alpha, near_grid_t, sigma_thresh, fs_std, min_vox_len,
                            only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid,
                            no_sh_surf_grad, contrib, d_alpha, d_t, d_col, g_rl, win, g_density,
                            g_surface, g_sh, g_fss, g_sh_mult, d_snorm};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (stype) {
        case SURF_SDF: return launch_backward_entry<SURF_SDF>(p, s);
        case SURF_UDF: return launch_backward_entry<SURF_UDF>(p, s);
        case SURF_UDF_ALPHA: return launch_backward_entry<SURF_UDF_ALPHA>(p, s);
        case SURF_UDF_FAKE_SAMPLE: return launch_backward_entry<SURF_UDF_FAKE_SAMPLE>(p, s);
        case SURF_PLANE: return launch_backward_entry<SURF_PLANE>(p, s);
        case SURF_VOXEL_FACE: return launch_backward_entry<SURF_VOXEL_FACE>(p, s);
        default: return cudaErrorInvalidValue;
    }
}
#endif
