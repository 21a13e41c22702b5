// K8 and K10: the Plenoxels ("cuvol") density renderer of the warm-start
// stage.
//
// K8 replaces the JAX package's render/cuvol.py:volume_render_cuvol_packed
// (79-288) and jax.grad of it. The pool comes from K2 (phase_a.cu) over the
// density occupancy of K1d (occupancy.cu): ray r owns the entries
// [offsets[r], offsets[r+1]), t-ascending. Each entry is an occupied voxel
// segment [close_t, far_t) and holds at most S = ceil(sqrt(3)/step)+1
// samples of the global lattice t = tmin + k*step (tmin the ray's cuvol
// bound). A sample's sigma is relu(trilerp of the 8 corner densities), its
// colour max(trilerp of the corner colours + 0.5, 0), its log attenuation
// -ws * sigma, ws = step * delta_scale (1e9 for the last sample before
// tmax with last_sample_opaque).
//
// - cuvol_forward, one thread per ray: walks the ray's entries in order,
//   gathers each entry's 8 corner rows once (density and the SH row,
//   contracted with the ray's basis as the row streams in, as K3 does) and
//   composites its samples with a running prefix. It writes rgb, depth,
//   log_T, optionally the first t where sigma > depth_sigma_thresh, and,
//   for the backward, the prefix at each entry's start (entry_pre, one
//   float per entry). The JAX version's chunk-wide cumsum minus a per-ray
//   base cancels in float32 (ROADMAP §3); a running sum does not.
// - cuvol_backward, one thread per ray: the cotangents of rgb and, in its
//   second instantiation, of depth and log_T (either may be null). It walks the entries
//   backwards carrying the suffix sum of w_k G_k plus the background term,
//   G_k = g . c_k + g_depth t_k, which is d loss / d log_att of every
//   earlier sample minus its own weight's term (every d log_att also gains
//   g_log_T), so no derivative is a difference of totals. Each entry's
//   samples are recomputed from entry_pre with the forward's code in the
//   forward's order, so their transmittances are the forward's bit for
//   bit. Per entry it sums the 8 corners' density and colour cotangents
//   over its samples in registers and issues one atomicAdd per corner
//   channel (8 x (1 + 3 bd)), as K5b does. With a g_sh_mult output (a
//   learned basis in training) it also gives the gradient of the ray's
//   basis, sum over its entries and corners of gc[c][ch] * row_c[ch bd + b]:
//   the thread owns its ray, so the bd sums stay in registers and are
//   written once, with no atomics. The kernel is templated on both
//   outputs; with neither it is the rgb-only code.
//
// K10 replaces render/cuvol.py:volume_render_cuvol (297-429), the dense
// fixed-step march: one thread per ray steps t = tmin + k*step while
// t <= tmax, for at most n_steps samples, with the edge-clamped trilerp of
// ops/trilerp.py:voxel_of.
// - cuvol_march, forward. For training (a ckpt output) it also writes the
//   ray's running log_T before every kSeg-th step, ceil(n_steps / kSeg)
//   floats a ray; without it the serving code is unchanged.
// - cuvol_march_backward, one thread per ray, jax.grad of the march: the
//   cotangents of rgb, depth and log_T into the density and SH rows, the
//   per-ray background colour (returned by the wrapper) and, with a
//   g_sh_mult output, the ray's basis. It walks the kSeg-step segments
//   from last to first. Each is re-marched forward from its checkpoint
//   with the forward's code in the forward's order (densities only),
//   keeping the prefix and sigma of its <= kSeg samples in local memory,
//   then walked backwards with K8's suffix rule. A sample with sigma <= 0
//   has weight 0 and a relu gradient of 0 and is skipped, so empty space
//   gathers no colour rows and issues no atomics. Consecutive samples
//   often share a voxel (2-3 at step 0.5): their 8 corner cotangents are
//   summed in registers and flushed by one atomicAdd per corner channel
//   when the walk leaves the voxel. Positions do not depend on the
//   parameters, so the edge clamp needs no derivative.
//
// Bound: K8 forward and K10 by the random 8-row gathers (each entry or
// sample reads 8 links and 8 rows of 1 + 3 bd floats; neighbouring rays
// share corners through the caches); K8 and K10 backward also by their
// atomics into the rows. Design: one thread per ray, no shared memory,
// nothing sorted; splitting the per-entry work from the per-ray walk is
// later work.
#include "common.cuh"

struct CuvolParams {
    const int64_t* offsets;  // (B+1,) pool range of each ray (K8)
    int B;
    const int* l;            // (M, 3) voxel of each entry (K8)
    const float* close_t;
    const float* far_t;
    const float* origins;    // (B, 3) grid space
    const float* dirs;       // (B, 3) unit grid-space directions
    const float* sh_mult;    // (B, bd)
    int bd;
    const float* delta_scale;  // (B,)
    const float* tmin;       // (B,) cuvol bounds
    const float* tmax;
    const int* links;
    int X, Y, Z;
    const float* density;    // (cap,)
    const float* sh;         // (cap, 3 bd)
    float step;
    int S;                   // K8: samples per entry; K10: steps per ray
    int lso;                 // last_sample_opaque
    float bg;
    const float* bg_rgb;     // (B, 3) per-ray background colour (K13), or null: bg
    int dst_on;
    float dst;
    float* rgb;              // (B, 3)
    float* depth;
    float* log_T;
    float* t_sig;            // (B,) or null
    float* entry_pre;        // (M,) or null
    float* ckpt;             // K10: (B, n_seg) log_T before every kSeg-th step, or null
    int n_seg;
    const float* g_rgb;      // (B, 3)
    const float* g_depth;    // (B,) or null
    const float* g_log_T;    // (B,) or null
    float* g_density;        // (cap,)
    float* g_sh;             // (cap, 3 bd)
    float* g_sh_mult;        // (B, bd) or null
};

// the widest basis whose per-ray gradient K8's backward keeps in registers
constexpr int kMaxBasis = 32;
// K10: steps between the forward's log_T checkpoints (the backward's
// segment, held in local memory)
constexpr int kSeg = 64;

// the background colour of ray r, channel ch
HD float bg_of(const CuvolParams& p, int r, int ch) {
    return p.bg_rgb ? p.bg_rgb[3 * (int64_t)r + ch] : p.bg;
}

struct Ray {
    float o[3], d[3];
    float ws, tmin, tmax;
    const float* shm;
};

HD Ray load_ray(const CuvolParams& p, int r) {
    Ray ray;
    for (int a = 0; a < 3; ++a) {
        ray.o[a] = p.origins[3 * (int64_t)r + a];
        ray.d[a] = p.dirs[3 * (int64_t)r + a];
    }
    ray.ws = p.step * p.delta_scale[r];
    ray.tmin = p.tmin[r];
    ray.tmax = p.tmax[r];
    ray.shm = p.sh_mult + (int64_t)r * p.bd;
    return ray;
}

// the 8 corners of voxel (x, y, z): links, densities and colours
// (sum_b sh * basis), 0 where a link is absent
struct CuvolCorners {
    int link[8];
    float sigma[8];
    float rgb[8][3];
};

HD void gather_cuvol_corners(const CuvolParams& p, const float* shm, int x, int y, int z,
                             CuvolCorners& cs) {
    const int C = 3 * p.bd;
    for (int c = 0; c < 8; ++c) {
        const int cx = clampi(x + corner_dx(c), 0, p.X - 1);
        const int cy = clampi(y + corner_dy(c), 0, p.Y - 1);
        const int cz = clampi(z + corner_dz(c), 0, p.Z - 1);
        const int link = p.links[((int64_t)cx * p.Y + cy) * p.Z + cz];
        cs.link[c] = link;
        if (link < 0) {
            cs.sigma[c] = 0.0f;
            for (int ch = 0; ch < 3; ++ch) cs.rgb[c][ch] = 0.0f;
            continue;
        }
        cs.sigma[c] = p.density[link];
        const float* row = p.sh + (int64_t)link * C;
        for (int ch = 0; ch < 3; ++ch) {
            float acc = row[ch * p.bd] * shm[0];
            for (int b = 1; b < p.bd; ++b) acc = acc + row[ch * p.bd + b] * shm[b];
            cs.rgb[c][ch] = acc;
        }
    }
}

// one sample at t inside voxel l, weights w8 at the clipped fraction
struct Sample {
    float w8[8];
    float sigma;    // trilerp of the densities (before the relu)
    float pre[3];   // trilerp of the colours + 0.5 (before the clip)
    float ws;
};

HD void eval_sample(const Ray& ray, const CuvolCorners& cs, float fx, float fy, float fz,
                    float ws, Sample& s) {
    trilerp_weights(fx, fy, fz, s.w8);
    s.sigma = corner_dot(s.w8, cs.sigma);
    for (int ch = 0; ch < 3; ++ch) {
        const float v[8] = {cs.rgb[0][ch], cs.rgb[1][ch], cs.rgb[2][ch], cs.rgb[3][ch],
                            cs.rgb[4][ch], cs.rgb[5][ch], cs.rgb[6][ch], cs.rgb[7][ch]};
        s.pre[ch] = corner_dot(s.w8, v) + 0.5f;
    }
    s.ws = ws;
}

// ---------------------------------------------------------------------------
// K8: one pool entry's samples
// ---------------------------------------------------------------------------

struct Entry {
    int l[3];
    float close_t, far_t, k0;
};

HD Entry load_entry(const CuvolParams& p, const Ray& ray, int64_t e) {
    Entry en;
    for (int a = 0; a < 3; ++a) en.l[a] = p.l[3 * e + a];
    en.close_t = p.close_t[e];
    en.far_t = p.far_t[e];
    en.k0 = ceilf((en.close_t - ray.tmin) / p.step - 1e-9f);
    return en;
}

// slot s of an entry: false when its t lies outside [close_t, far_t)
HD bool entry_slot(const CuvolParams& p, const Ray& ray, const Entry& en, const CuvolCorners& cs,
                   int s, float& t, Sample& smp) {
    t = ray.tmin + (en.k0 + (float)s) * p.step;
    if (!(t < en.far_t && t >= en.close_t - 1e-9f)) return false;
    float f[3];
    for (int a = 0; a < 3; ++a) {
        f[a] = ray.o[a] + t * ray.d[a] - (float)en.l[a];
        f[a] = fminf(fmaxf(f[a], 0.0f), 1.0f);
    }
    const float ws = (p.lso && t + p.step > ray.tmax) ? 1e9f : ray.ws;
    eval_sample(ray, cs, f[0], f[1], f[2], ws, smp);
    return true;
}

HD float log_att_of(const Sample& s) { return -s.ws * fmaxf(s.sigma, 0.0f); }

HD void cuvol_forward_ray(const CuvolParams& p, int r) {
    const Ray ray = load_ray(p, r);
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    float pre_att = 0.0f, depth = 0.0f, t_sig = INFINITY;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t e = e0; e < e1; ++e) {
        if (p.entry_pre) p.entry_pre[e] = pre_att;
        const Entry en = load_entry(p, ray, e);
        CuvolCorners cs;
        gather_cuvol_corners(p, ray.shm, en.l[0], en.l[1], en.l[2], cs);
        for (int s = 0; s < p.S; ++s) {
            float t;
            Sample smp;
            if (!entry_slot(p, ray, en, cs, s, t, smp)) continue;
            const float la = log_att_of(smp);
            const float w = expf(fminf(pre_att, 0.0f)) * (1.0f - expf(la));
            for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + w * fmaxf(smp.pre[ch], 0.0f);
            depth = depth + w * t;
            pre_att = pre_att + la;
            if (p.dst_on && smp.sigma > p.dst) t_sig = fminf(t_sig, t);
        }
    }
    const float T = expf(pre_att);
    for (int ch = 0; ch < 3; ++ch) p.rgb[3 * (int64_t)r + ch] = rgb[ch] + T * bg_of(p, r, ch);
    p.depth[r] = depth;
    p.log_T[r] = pre_att;
    if (p.t_sig) p.t_sig[r] = finite(t_sig) ? t_sig : 0.0f;
}

// d rgb / d log_att of every sample includes the background's exp(log_T) g . bg
HD float bg_dot(const CuvolParams& p, int r, const float g[3]) {
    return p.bg_rgb ? g[0] * bg_of(p, r, 0) + g[1] * bg_of(p, r, 1) + g[2] * bg_of(p, r, 2)
                    : p.bg * (g[0] + g[1] + g[2]);
}

// one atomicAdd per corner channel of a voxel's summed cotangents gd
// (density) and gc (colour, before the contraction with the basis), zeros
// and absent links skipped; with kShMult the basis gradient into gshm
template <bool kShMult>
HD void flush_corners(const CuvolParams& p, const Ray& ray, const CuvolCorners& cs,
                      const float gd[8], const float gc[8][3], float* gshm) {
    const int C = 3 * p.bd;
    for (int c = 0; c < 8; ++c) {
        const int link = cs.link[c];
        if (link < 0) continue;
        if (gd[c] != 0.0f) atomic_add(p.g_density + link, gd[c]);
        float* row = p.g_sh + (int64_t)link * C;
        const float* sh_row = p.sh + (int64_t)link * C;
        for (int ch = 0; ch < 3; ++ch) {
            if (gc[c][ch] == 0.0f) continue;
            for (int b = 0; b < p.bd; ++b)
                atomic_add(row + ch * p.bd + b, gc[c][ch] * ray.shm[b]);
            if (kShMult) {
#pragma unroll
                for (int b = 0; b < kMaxBasis; ++b)
                    if (b < p.bd) gshm[b] = gshm[b] + gc[c][ch] * sh_row[ch * p.bd + b];
            }
        }
    }
}

template <bool kShMult>
HD void store_sh_mult_grad(const CuvolParams& p, int r, const float* gshm) {
    if (kShMult) {
#pragma unroll
        for (int b = 0; b < kMaxBasis; ++b)
            if (b < p.bd) p.g_sh_mult[(int64_t)r * p.bd + b] = gshm[b];
    }
}

template <bool kShMult, bool kOut>
HD void cuvol_backward_ray(const CuvolParams& p, int r) {
    const Ray ray = load_ray(p, r);
    float gshm[kMaxBasis];
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) gshm[b] = 0.0f;
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    const float g[3] = {p.g_rgb[3 * (int64_t)r], p.g_rgb[3 * (int64_t)r + 1],
                        p.g_rgb[3 * (int64_t)r + 2]};
    const float g_depth = kOut && p.g_depth ? p.g_depth[r] : 0.0f;
    const float g_log_T = kOut && p.g_log_T ? p.g_log_T[r] : 0.0f;
    float suffix = expf(p.log_T[r]) * bg_dot(p, r, g);
    for (int64_t e = e1 - 1; e >= e0; --e) {
        const Entry en = load_entry(p, ray, e);
        CuvolCorners cs;
        gather_cuvol_corners(p, ray.shm, en.l[0], en.l[1], en.l[2], cs);
        float gd[8], gc[8][3];
        for (int c = 0; c < 8; ++c) {
            gd[c] = 0.0f;
            for (int ch = 0; ch < 3; ++ch) gc[c][ch] = 0.0f;
        }
        for (int s = p.S - 1; s >= 0; --s) {
            float t;
            Sample smp;
            if (!entry_slot(p, ray, en, cs, s, t, smp)) continue;
            // the prefix at slot s, summed in the forward's order
            float pre = p.entry_pre[e];
            for (int q = 0; q < s; ++q) {
                float tq;
                Sample sq;
                const float la_q = entry_slot(p, ray, en, cs, q, tq, sq) ? log_att_of(sq) : 0.0f;
                pre = pre + la_q;
            }
            const float la = log_att_of(smp);
            const float T = expf(fminf(pre, 0.0f));
            const float ea = expf(la);
            const float w = T * (1.0f - ea);
            float rgb[3], G = 0.0f;
            for (int ch = 0; ch < 3; ++ch) {
                rgb[ch] = fmaxf(smp.pre[ch], 0.0f);
                G = G + g[ch] * rgb[ch];
            }
            if (kOut) G = G + g_depth * t;
            float d_la = -T * ea * G + suffix;
            if (kOut) d_la = d_la + g_log_T;
            suffix = suffix + w * G;
            const float d_sigma = smp.sigma > 0.0f ? -smp.ws * d_la : 0.0f;
            float d_pre[3];
            for (int ch = 0; ch < 3; ++ch) d_pre[ch] = w * g[ch] * clip_lo_grad(smp.pre[ch], 0.0f);
            for (int c = 0; c < 8; ++c) {
                gd[c] = gd[c] + smp.w8[c] * d_sigma;
                for (int ch = 0; ch < 3; ++ch) gc[c][ch] = gc[c][ch] + smp.w8[c] * d_pre[ch];
            }
        }
        flush_corners<kShMult>(p, ray, cs, gd, gc, gshm);
    }
    store_sh_mult_grad<kShMult>(p, r, gshm);
}

// ---------------------------------------------------------------------------
// K10: the dense march
// ---------------------------------------------------------------------------

// the edge-clamped voxel l and fraction f of the march's sample at t
// (ops/trilerp.py:voxel_of)
HD void march_voxel(const CuvolParams& p, const Ray& ray, float t, int l[3], float f[3]) {
    const float hi[3] = {(float)p.X - 1.0f, (float)p.Y - 1.0f, (float)p.Z - 1.0f};
    const int lmax[3] = {p.X - 2, p.Y - 2, p.Z - 2};
    for (int a = 0; a < 3; ++a) {
        const float pos = fminf(fmaxf(ray.o[a] + t * ray.d[a], 0.0f), hi[a]);
        l[a] = clampi((int)pos, 0, lmax[a]);
        f[a] = pos - (float)l[a];
    }
}

HD float march_ws(const CuvolParams& p, const Ray& ray, float t) {
    return (p.lso && t + p.step > ray.tmax) ? 1e9f : ray.ws;
}

template <bool kCkpt>
HD void cuvol_march_ray(const CuvolParams& p, int r) {
    const Ray ray = load_ray(p, r);
    float log_T = 0.0f, depth = 0.0f, t_sig = INFINITY;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < p.S; ++k) {
        const float t = ray.tmin + (float)k * p.step;
        if (!(t <= ray.tmax)) break;  // t rises with k: no later sample is active
        if (kCkpt && k % kSeg == 0) p.ckpt[(int64_t)r * p.n_seg + k / kSeg] = log_T;
        int l[3];
        float f[3];
        march_voxel(p, ray, t, l, f);
        CuvolCorners cs;
        gather_cuvol_corners(p, ray.shm, l[0], l[1], l[2], cs);
        Sample smp;
        eval_sample(ray, cs, f[0], f[1], f[2], march_ws(p, ray, t), smp);
        const float la = log_att_of(smp);
        const float w = expf(log_T) * (1.0f - expf(la));
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + w * fmaxf(smp.pre[ch], 0.0f);
        depth = depth + w * t;
        log_T = log_T + la;
        if (p.dst_on && smp.sigma > p.dst) t_sig = fminf(t_sig, t);
    }
    const float T = expf(log_T);
    for (int ch = 0; ch < 3; ++ch) p.rgb[3 * (int64_t)r + ch] = rgb[ch] + T * bg_of(p, r, ch);
    p.depth[r] = depth;
    p.log_T[r] = log_T;
    if (p.t_sig) p.t_sig[r] = finite(t_sig) ? t_sig : 0.0f;
}

HD bool same_voxel(const int a[3], const int b[3]) {
    return a[0] == b[0] && a[1] == b[1] && a[2] == b[2];
}

template <bool kShMult>
HD void cuvol_march_backward_ray(const CuvolParams& p, int r) {
    const Ray ray = load_ray(p, r);
    float gshm[kMaxBasis];
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) gshm[b] = 0.0f;
    const float g[3] = {p.g_rgb[3 * (int64_t)r], p.g_rgb[3 * (int64_t)r + 1],
                        p.g_rgb[3 * (int64_t)r + 2]};
    const float g_depth = p.g_depth ? p.g_depth[r] : 0.0f;
    const float g_log_T = p.g_log_T ? p.g_log_T[r] : 0.0f;
    int K = 0;  // the forward's samples
    while (K < p.S && ray.tmin + (float)K * p.step <= ray.tmax) ++K;
    float suffix = expf(p.log_T[r]) * bg_dot(p, r, g);
    float pre[kSeg], sig[kSeg];  // a segment's prefixes and sigmas
    int dv[3] = {-1, -1, -1};    // the voxel of the re-march's densities
    float dens[8];
    int bv[3] = {-1, -1, -1};    // the voxel of the reverse walk's corners and sums
    CuvolCorners cs;
    float gd[8], gc[8][3];
    for (int c = 0; c < 8; ++c) {
        gd[c] = 0.0f;
        for (int ch = 0; ch < 3; ++ch) gc[c][ch] = 0.0f;
    }
    for (int seg = (K - 1) / kSeg; seg >= 0 && K > 0; --seg) {
        const int k0 = seg * kSeg, k1 = k0 + kSeg < K ? k0 + kSeg : K;
        // the forward's prefixes, in its order, from the checkpoint
        float run = p.ckpt[(int64_t)r * p.n_seg + seg];
        for (int k = k0; k < k1; ++k) {
            const float t = ray.tmin + (float)k * p.step;
            int l[3];
            float f[3];
            march_voxel(p, ray, t, l, f);
            if (!same_voxel(l, dv)) {
                for (int c = 0; c < 8; ++c) {
                    const int cx = clampi(l[0] + corner_dx(c), 0, p.X - 1);
                    const int cy = clampi(l[1] + corner_dy(c), 0, p.Y - 1);
                    const int cz = clampi(l[2] + corner_dz(c), 0, p.Z - 1);
                    const int link = p.links[((int64_t)cx * p.Y + cy) * p.Z + cz];
                    dens[c] = link < 0 ? 0.0f : p.density[link];
                }
                for (int a = 0; a < 3; ++a) dv[a] = l[a];
            }
            float w8[8];
            trilerp_weights(f[0], f[1], f[2], w8);
            const float sigma = corner_dot(w8, dens);
            pre[k - k0] = run;
            sig[k - k0] = sigma;
            run = run + -march_ws(p, ray, t) * fmaxf(sigma, 0.0f);
        }
        for (int k = k1 - 1; k >= k0; --k) {
            if (!(sig[k - k0] > 0.0f)) continue;  // weight 0, relu gradient 0
            const float t = ray.tmin + (float)k * p.step;
            int l[3];
            float f[3];
            march_voxel(p, ray, t, l, f);
            if (!same_voxel(l, bv)) {
                if (bv[0] >= 0) flush_corners<kShMult>(p, ray, cs, gd, gc, gshm);
                gather_cuvol_corners(p, ray.shm, l[0], l[1], l[2], cs);
                for (int a = 0; a < 3; ++a) bv[a] = l[a];
                for (int c = 0; c < 8; ++c) {
                    gd[c] = 0.0f;
                    for (int ch = 0; ch < 3; ++ch) gc[c][ch] = 0.0f;
                }
            }
            Sample smp;
            eval_sample(ray, cs, f[0], f[1], f[2], march_ws(p, ray, t), smp);
            const float la = log_att_of(smp);
            const float T = expf(pre[k - k0]);
            const float ea = expf(la);
            const float w = T * (1.0f - ea);
            float G = 0.0f;
            for (int ch = 0; ch < 3; ++ch) G = G + g[ch] * fmaxf(smp.pre[ch], 0.0f);
            G = G + g_depth * t;
            const float d_la = -T * ea * G + suffix + g_log_T;
            suffix = suffix + w * G;
            const float d_sigma = -smp.ws * d_la;
            float d_pre[3];
            for (int ch = 0; ch < 3; ++ch) d_pre[ch] = w * g[ch] * clip_lo_grad(smp.pre[ch], 0.0f);
            for (int c = 0; c < 8; ++c) {
                gd[c] = gd[c] + smp.w8[c] * d_sigma;
                for (int ch = 0; ch < 3; ++ch) gc[c][ch] = gc[c][ch] + smp.w8[c] * d_pre[ch];
            }
        }
    }
    if (bv[0] >= 0) flush_corners<kShMult>(p, ray, cs, gd, gc, gshm);
    store_sh_mult_grad<kShMult>(p, r, gshm);
}

#ifdef __CUDACC__
__global__ void cuvol_forward_kernel(CuvolParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) cuvol_forward_ray(p, r);
}

template <bool kShMult, bool kOut>
__global__ void cuvol_backward_kernel(CuvolParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) cuvol_backward_ray<kShMult, kOut>(p, r);
}

template <bool kCkpt>
__global__ void cuvol_march_kernel(CuvolParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) cuvol_march_ray<kCkpt>(p, r);
}

template <bool kShMult>
__global__ void cuvol_march_backward_kernel(CuvolParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) cuvol_march_backward_ray<kShMult>(p, r);
}

static CuvolParams make_params(const int64_t* offsets, int B, const int* l, const float* close_t,
                               const float* far_t, const float* origins, const float* dirs,
                               const float* sh_mult, int bd, const float* delta_scale,
                               const float* tmin, const float* tmax, const int* links, int X,
                               int Y, int Z, const float* density, const float* sh, float step,
                               int S, int lso, float bg, const float* bg_rgb, int dst_on,
                               float dst) {
    CuvolParams p{};
    p.offsets = offsets;
    p.B = B;
    p.l = l;
    p.close_t = close_t;
    p.far_t = far_t;
    p.origins = origins;
    p.dirs = dirs;
    p.sh_mult = sh_mult;
    p.bd = bd;
    p.delta_scale = delta_scale;
    p.tmin = tmin;
    p.tmax = tmax;
    p.links = links;
    p.X = X;
    p.Y = Y;
    p.Z = Z;
    p.density = density;
    p.sh = sh;
    p.step = step;
    p.S = S;
    p.lso = lso;
    p.bg = bg;
    p.bg_rgb = bg_rgb;
    p.dst_on = dst_on;
    p.dst = dst;
    return p;
}

static const int kBlock = 128;

extern "C" cudaError_t cuvol_forward(const int64_t* offsets, int B, const int* l,
                                     const float* close_t, const float* far_t,
                                     const float* origins, const float* dirs, const float* sh_mult,
                                     int bd, const float* delta_scale, const float* tmin,
                                     const float* tmax, const int* links, int X, int Y, int Z,
                                     const float* density, const float* sh, float step, int S,
                                     int lso, float bg, const float* bg_rgb, int dst_on,
                                     float dst, float* rgb,
                                     float* depth, float* log_T, float* t_sig, float* entry_pre,
                                     void* stream) {
    if (B <= 0) return cudaSuccess;
    CuvolParams p = make_params(offsets, B, l, close_t, far_t, origins, dirs, sh_mult, bd,
                                delta_scale, tmin, tmax, links, X, Y, Z, density, sh, step, S, lso,
                                bg, bg_rgb, dst_on, dst);
    p.rgb = rgb;
    p.depth = depth;
    p.log_T = log_T;
    p.t_sig = t_sig;
    p.entry_pre = entry_pre;
    cuvol_forward_kernel<<<(B + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}

extern "C" cudaError_t cuvol_backward(const int64_t* offsets, int B, const int* l,
                                      const float* close_t, const float* far_t,
                                      const float* origins, const float* dirs,
                                      const float* sh_mult, int bd, const float* delta_scale,
                                      const float* tmin, const float* tmax, const int* links,
                                      int X, int Y, int Z, const float* density, const float* sh,
                                      float step, int S, int lso, float bg,
                                      const float* bg_rgb, const float* log_T,
                                      const float* entry_pre, const float* g_rgb,
                                      const float* g_depth, const float* g_log_T,
                                      float* g_density, float* g_sh, float* g_sh_mult,
                                      void* stream) {
    if (B <= 0) return cudaSuccess;
    if (g_sh_mult && bd > kMaxBasis) return cudaErrorInvalidValue;
    CuvolParams p = make_params(offsets, B, l, close_t, far_t, origins, dirs, sh_mult, bd,
                                delta_scale, tmin, tmax, links, X, Y, Z, density, sh, step, S, lso,
                                bg, bg_rgb, 0, 0.0f);
    p.log_T = const_cast<float*>(log_T);
    p.entry_pre = const_cast<float*>(entry_pre);
    p.g_rgb = g_rgb;
    p.g_depth = g_depth;
    p.g_log_T = g_log_T;
    p.g_density = g_density;
    p.g_sh = g_sh;
    p.g_sh_mult = g_sh_mult;
    const unsigned grid = (B + kBlock - 1) / kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const bool out = g_depth || g_log_T;
    if (g_sh_mult && out)
        cuvol_backward_kernel<true, true><<<grid, kBlock, 0, st>>>(p);
    else if (g_sh_mult)
        cuvol_backward_kernel<true, false><<<grid, kBlock, 0, st>>>(p);
    else if (out)
        cuvol_backward_kernel<false, true><<<grid, kBlock, 0, st>>>(p);
    else
        cuvol_backward_kernel<false, false><<<grid, kBlock, 0, st>>>(p);
    return cudaGetLastError();
}

static int march_segments(int n_steps) { return (n_steps + kSeg - 1) / kSeg; }

extern "C" cudaError_t cuvol_march(int B, const float* origins, const float* dirs,
                                   const float* sh_mult, int bd, const float* delta_scale,
                                   const float* tmin, const float* tmax, const int* links, int X,
                                   int Y, int Z, const float* density, const float* sh,
                                   float step, int n_steps, int lso, float bg,
                                   const float* bg_rgb, int dst_on, float dst, float* rgb,
                                   float* depth, float* log_T, float* t_sig, float* ckpt,
                                   void* stream) {
    if (B <= 0) return cudaSuccess;
    CuvolParams p = make_params(nullptr, B, nullptr, nullptr, nullptr, origins, dirs, sh_mult, bd,
                                delta_scale, tmin, tmax, links, X, Y, Z, density, sh, step,
                                n_steps, lso, bg, bg_rgb, dst_on, dst);
    p.rgb = rgb;
    p.depth = depth;
    p.log_T = log_T;
    p.t_sig = t_sig;
    p.ckpt = ckpt;
    p.n_seg = march_segments(n_steps);
    const unsigned grid = (B + kBlock - 1) / kBlock;
    if (ckpt)
        cuvol_march_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(p);
    else
        cuvol_march_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}

extern "C" cudaError_t cuvol_march_backward(int B, const float* origins, const float* dirs,
                                            const float* sh_mult, int bd,
                                            const float* delta_scale, const float* tmin,
                                            const float* tmax, const int* links, int X, int Y,
                                            int Z, const float* density, const float* sh,
                                            float step, int n_steps, int lso, float bg,
                                            const float* bg_rgb, const float* log_T,
                                            const float* ckpt, const float* g_rgb,
                                            const float* g_depth, const float* g_log_T,
                                            float* g_density, float* g_sh, float* g_sh_mult,
                                            void* stream) {
    if (B <= 0) return cudaSuccess;
    if (g_sh_mult && bd > kMaxBasis) return cudaErrorInvalidValue;
    CuvolParams p = make_params(nullptr, B, nullptr, nullptr, nullptr, origins, dirs, sh_mult, bd,
                                delta_scale, tmin, tmax, links, X, Y, Z, density, sh, step,
                                n_steps, lso, bg, bg_rgb, 0, 0.0f);
    p.log_T = const_cast<float*>(log_T);
    p.ckpt = const_cast<float*>(ckpt);
    p.n_seg = march_segments(n_steps);
    p.g_rgb = g_rgb;
    p.g_depth = g_depth;
    p.g_log_T = g_log_T;
    p.g_density = g_density;
    p.g_sh = g_sh;
    p.g_sh_mult = g_sh_mult;
    const unsigned grid = (B + kBlock - 1) / kBlock;
    if (g_sh_mult)
        cuvol_march_backward_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(p);
    else
        cuvol_march_backward_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}
#endif
