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
// What bounds K8 on the H100: the gathers of each entry's 8 corner rows
// (8 links, 8 densities, 8 SH rows of 3 bd floats, read at random from a
// grid far larger than L2) and, for the backward, the adds of each entry's
// corner cotangents into g_density and g_sh. A warm-start step has ~250
// entries a ray and ~1.2 samples an entry (40,960 rays, 10.4 M entries at
// 256^3). One thread walking a ray's pool kept one gather in flight a ray
// and issued 8 (1 + 3 bd) scalar atomics an entry. K8's design:
// - A warp per ray, lane i on the entry base + i of a group of 32
//   consecutive entries. Consecutive entries are mostly face neighbours
//   (4 shared corners): a lane reads only the rows of the corners it does
//   not share with the lane below (its SH row contracted with the ray's
//   basis as it streams in, as K3 does), and takes the others from that
//   lane by shuffles. Each lane composites its entry's <= S samples at a
//   local transmittance of 1.
// - cuvol_forward: a warp prefix scan of the entries' summed log
//   attenuations gives each entry's prefix (entry_pre, for the backward),
//   carried from one group to the next, so every prefix is a per-ray sum
//   (the JAX version's chunk-wide cumsum minus a per-ray base cancels in
//   float32, ROADMAP §3); warp sums of exp(entry_pre) times each entry's
//   local rgb and depth, and a warp minimum of its first t with
//   sigma > depth_sigma_thresh, give the ray's outputs.
// - cuvol_backward: the cotangents of rgb and, in its second
//   instantiation, of depth and log_T (either may be null). It walks the
//   groups from the ray's last entry to its first. Each lane sums its
//   entry's w_k G_k (G_k = g . c_k + g_depth t_k, d loss / d w_k); a warp
//   suffix scan of those, carried down from the group above and started at
//   the background's exp(log_T) g . bg, gives the suffix at each entry's
//   end. A second pass over the entry's samples in the forward's order
//   gives d loss / d log_att of each: -T e^{la} G plus that suffix and the
//   entry's own sum after the sample (plus g_log_T), O(S) an entry. Each
//   lane sums its 8 corners' density and colour cotangents in registers.
// - Fewer atomics. A lane hands the sums of the corners it shares with the
//   entry below to that entry's lane (a shuffle, the corner index mapped by
//   the axes the voxels differ on), one channel at a time, in rounds, so
//   that the lowest entry of each run that touches a vertex adds it once;
//   the group's lowest lane hands its share to the next group through
//   shared memory. Each lane adds its density sums (one atomic a corner);
//   the warp lists the SH rows to add in shared memory and adds them with
//   float4 atomics, a row's 3 bd elements in the 16-byte slots they lie in,
//   several rows an instruction, zeros and absent links skipped. With a
//   g_sh_mult output (a learned basis) the warp also sums the ray's basis
//   gradient, sum over the added corners of gc[ch] row[ch bd + b], lane by
//   lane, and writes it once, with no atomics. bd is at most 32.
// - Registers: the kernels are capped at 96 (forward) and 128 (backward)
//   registers a thread for occupancy. SH rows staged in shared memory (a
//   coalesced load a row) measured slower than each lane's own row loads,
//   whose consecutive floats hit the same L1 lines (PERF.md §6).
// Tensor cores, TMA and wgmma have no part here: the work is scattered
// gathers, scans and atomics.
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
//   then walked backwards with the suffix rule above. A sample with
//   sigma <= 0 has weight 0 and a relu gradient of 0 and is skipped, so
//   empty space gathers no colour rows and issues no atomics. Consecutive
//   samples often share a voxel (2-3 at step 0.5): their 8 corner
//   cotangents are summed in registers and flushed by one atomicAdd per
//   corner channel when the walk leaves the voxel. Positions do not depend
//   on the parameters, so the edge clamp needs no derivative.
// Bound: K10 by the random 8-row gathers of every sample (neighbouring
// rays share corners through the caches), its backward also by the
// atomics. Design: one thread per ray, no shared memory, nothing sorted.
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
    int cap;                 // K8 backward: rows of density and SH
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

// the widest basis K8's backward takes (its warp's SH row lanes; the
// per-ray basis gradient of K10's backward in registers)
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

// an entry's samples composited at a transmittance of 1 at its start: its
// summed log attenuation, rgb and depth, and its first t with
// sigma > depth_sigma_thresh (inf for none)
struct EntryLocal {
    float la, rgb[3], depth, t_sig;
};

HD EntryLocal composite_entry(const CuvolParams& p, const Ray& ray, const Entry& en,
                              const CuvolCorners& cs) {
    EntryLocal o{0.0f, {0.0f, 0.0f, 0.0f}, 0.0f, INFINITY};
    for (int s = 0; s < p.S; ++s) {
        float t;
        Sample smp;
        if (!entry_slot(p, ray, en, cs, s, t, smp)) continue;
        const float la = log_att_of(smp);
        const float w = expf(o.la) * (1.0f - expf(la));
        for (int ch = 0; ch < 3; ++ch) o.rgb[ch] = o.rgb[ch] + w * fmaxf(smp.pre[ch], 0.0f);
        o.depth = o.depth + w * t;
        o.la = o.la + la;
        if (p.dst_on && smp.sigma > p.dst) o.t_sig = fminf(o.t_sig, t);
    }
    return o;
}

// d rgb / d log_att of every sample includes the background's exp(log_T) g . bg
HD float bg_dot(const CuvolParams& p, int r, const float g[3]) {
    return p.bg_rgb ? g[0] * bg_of(p, r, 0) + g[1] * bg_of(p, r, 1) + g[2] * bg_of(p, r, 2)
                    : p.bg * (g[0] + g[1] + g[2]);
}

// the output cotangents of one ray
struct RayGrad {
    float g[3], g_depth, g_log_T;
};

// G of a sample: d loss / d its weight
template <bool kOut>
HD float weight_grad(const RayGrad& rg, const Sample& smp, float t) {
    float G = 0.0f;
    for (int ch = 0; ch < 3; ++ch) G = G + rg.g[ch] * fmaxf(smp.pre[ch], 0.0f);
    if (kOut) G = G + rg.g_depth * t;
    return G;
}

// the entry's sum of w_k G_k over its samples, w_k at the global prefix
// pre0 + the entry's running sum (the backward's first pass)
template <bool kOut>
HD float entry_weighted_grad(const CuvolParams& p, const Ray& ray, const Entry& en,
                             const CuvolCorners& cs, float pre0, const RayGrad& rg) {
    float pre = pre0, A = 0.0f;
    for (int s = 0; s < p.S; ++s) {
        float t;
        Sample smp;
        if (!entry_slot(p, ray, en, cs, s, t, smp)) continue;
        const float la = log_att_of(smp);
        const float w = expf(fminf(pre, 0.0f)) * (1.0f - expf(la));
        A = A + w * weight_grad<kOut>(rg, smp, t);
        pre = pre + la;
    }
    return A;
}

// The entry's corner cotangents (the second pass): d loss / d log_att of
// sample k is -T_k e^{la_k} G_k plus the suffix after it, s_end + (A - c_k)
// with c_k the entry's running sum of w G through k (the first pass's sum
// in its order, so it reaches A exactly), plus g_log_T. acc[c][0] gains
// the corner's density cotangent, acc[c][1 + ch] its colour channel's
// (before the contraction with the basis).
template <bool kOut>
HD void entry_corner_grads(const CuvolParams& p, const Ray& ray, const Entry& en,
                           const CuvolCorners& cs, float pre0, float s_end, float A,
                           const RayGrad& rg, float acc[8][4]) {
    float pre = pre0, c = 0.0f;
    for (int s = 0; s < p.S; ++s) {
        float t;
        Sample smp;
        if (!entry_slot(p, ray, en, cs, s, t, smp)) continue;
        const float la = log_att_of(smp);
        const float T = expf(fminf(pre, 0.0f));
        const float ea = expf(la);
        const float w = T * (1.0f - ea);
        const float G = weight_grad<kOut>(rg, smp, t);
        c = c + w * G;
        float d_la = -T * ea * G + (s_end + (A - c));
        if (kOut) d_la = d_la + rg.g_log_T;
        const float d_sigma = smp.sigma > 0.0f ? -smp.ws * d_la : 0.0f;
        float d_pre[3];
        for (int ch = 0; ch < 3; ++ch) d_pre[ch] = w * rg.g[ch] * clip_lo_grad(smp.pre[ch], 0.0f);
        for (int k = 0; k < 8; ++k) {
            acc[k][0] = acc[k][0] + smp.w8[k] * d_sigma;
            for (int ch = 0; ch < 3; ++ch) acc[k][1 + ch] = acc[k][1 + ch] + smp.w8[k] * d_pre[ch];
        }
        pre = pre + la;
    }
}

// ---------------------------------------------------------------------------
// K10: the dense march
// ---------------------------------------------------------------------------

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
// ---------------------------------------------------------------------------
// K8 on the card: a warp per ray, lane i on the ray's entry base + i
// ---------------------------------------------------------------------------

// warps of a K8 block, and the SH row's lanes: 3 bd <= 3 kMaxBasis = 96
// elements, kRowChunks rounds of 32 lanes
constexpr int kK8Warps = 4;
constexpr int kRowChunks = (3 * kMaxBasis + 31) / 32;
// blocks an SM the kernels are compiled for: at most 96 registers a thread
// in the forward, 128 in the backward (uncapped they take 128 and 168; the
// caps' occupancy outweighs the backward's few spills, and tighter caps
// spill more than they gain: PERF.md §6)
constexpr int kK8ForwardBlocks = 5;
constexpr int kK8BackwardBlocks = 4;

// The 8 corners of each valid lane's voxel l, as gather_cuvol_corners gives
// them (the same contraction in the same order, so the same bits). A
// corner the lane shares with the lane below (the entry before it on the
// ray, a face neighbour: 4 corners) is that lane's: it comes by shuffles, a
// lane a round, and the lane reads only the rows of its own corners. Every
// lane of the warp calls it.
__device__ __forceinline__ void gather_corners_warp(const CuvolParams& p, const float* shm,
                                                    bool valid, const int l[3], CuvolCorners& cs,
                                                    int lane) {
    const int C = 3 * p.bd;
    int v[3], lo[3];
    for (int a = 0; a < 3; ++a) {
        v[a] = valid ? l[a] : -4;  // no voxel's neighbour
        lo[a] = __shfl_up_sync(kFullWarp, v[a], 1);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        int link = -1;
        if (valid) {
            const int cx = clampi(l[0] + corner_dx(c), 0, p.X - 1);
            const int cy = clampi(l[1] + corner_dy(c), 0, p.Y - 1);
            const int cz = clampi(l[2] + corner_dz(c), 0, p.Z - 1);
            link = p.links[((int64_t)cx * p.Y + cy) * p.Z + cz];
        }
        cs.link[c] = link;
    }
    int flip = 0;
    unsigned take = valid && lane > 0 ? shared_corners(v, lo, cs.link, flip) : 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int link = (take >> c) & 1u ? -1 : cs.link[c];
        cs.sigma[c] = 0.0f;
        for (int ch = 0; ch < 3; ++ch) cs.rgb[c][ch] = 0.0f;
        if (link < 0) continue;
        cs.sigma[c] = p.density[link];
        const float* row = p.sh + (int64_t)link * C;
        for (int ch = 0; ch < 3; ++ch) {
            float acc = row[ch * p.bd] * shm[0];
            for (int b = 1; b < p.bd; ++b) acc = acc + row[ch * p.bd + b] * shm[b];
            cs.rgb[c][ch] = acc;
        }
    }
    // the shared corners, one value at a time: a vertex in k consecutive
    // entries takes k - 1 rounds
    unsigned have = ~take & 0xffu;
    while (__any_sync(kFullWarp, take != 0u)) {
        const unsigned have_lo = __shfl_up_sync(kFullWarp, have, 1);
        unsigned got_now = 0u;  // the corners this round resolves
#pragma unroll
        for (int c = 0; c < 8; ++c)
            if (((take >> c) & 1u) && ((have_lo >> (c ^ flip)) & 1u)) got_now |= 1u << c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float got[8];
#pragma unroll
            for (int c = 0; c < 8; ++c)
                got[c] = __shfl_up_sync(kFullWarp, k == 0 ? cs.sigma[c] : cs.rgb[c][k - 1], 1);
            flip_corners(got, flip);  // got[c]: the lane below's corner c ^ flip
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                if (!((got_now >> c) & 1u)) continue;
                if (k == 0)
                    cs.sigma[c] = got[c];
                else
                    cs.rgb[c][k - 1] = got[c];
            }
        }
        take &= ~got_now;
        have |= got_now;
    }
}

__global__ void __launch_bounds__(32 * kK8Warps, kK8ForwardBlocks)
    cuvol_forward_kernel(CuvolParams p) {
    const int lane = threadIdx.x & 31;
    const int r = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    if (r >= p.B) return;  // the whole warp
    const Ray ray = load_ray(p, r);
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    float pre = 0.0f, depth = 0.0f, t_sig = INFINITY;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t base = e0; base < e1; base += 32) {
        const int64_t e = base + lane;
        const bool valid = e < e1;
        Entry en;
        if (valid) en = load_entry(p, ray, e);
        CuvolCorners cs;
        gather_corners_warp(p, ray.shm, valid, en.l, cs, lane);
        EntryLocal loc{0.0f, {0.0f, 0.0f, 0.0f}, 0.0f, INFINITY};
        if (valid) loc = composite_entry(p, ray, en, cs);
        // each entry's prefix: the carried prefix plus the lanes below
        const float incl = warp_prefix(loc.la, lane);
        const float below = __shfl_up_sync(kFullWarp, incl, 1);
        const float e_pre = lane > 0 ? pre + below : pre;
        if (e < e1 && p.entry_pre) p.entry_pre[e] = e_pre;
        const float T = expf(fminf(e_pre, 0.0f));
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + warp_allsum(T * loc.rgb[ch]);
        depth = depth + warp_allsum(T * loc.depth);
        t_sig = fminf(t_sig, warp_allmin(loc.t_sig));
        pre = pre + __shfl_sync(kFullWarp, incl, 31);
    }
    if (lane == 0) {
        const float T = expf(pre);
        for (int ch = 0; ch < 3; ++ch)
            p.rgb[3 * (int64_t)r + ch] = rgb[ch] + T * bg_of(p, r, ch);
        p.depth[r] = depth;
        p.log_T[r] = pre;
        if (p.t_sig) p.t_sig[r] = finite(t_sig) ? t_sig : 0.0f;
    }
}

template <bool kShMult, bool kOut>
__global__ void __launch_bounds__(32 * kK8Warps, kK8BackwardBlocks)
    cuvol_backward_kernel(CuvolParams p) {
    // per warp: the corner sums that leave a group for the entry below it,
    // double-buffered (written in one group, read in the next)
    __shared__ float s_carry[kK8Warps][2][32];
    __shared__ int s_flip[kK8Warps][2];
    __shared__ float s_basis[kK8Warps][3 * kMaxBasis];
    // per warp: the SH rows a group adds, their links and colour sums
    __shared__ int s_link[kK8Warps][8 * 32];
    __shared__ float s_gc[kK8Warps][8 * 32][3];
    // per warp: the channel of element j of an SH row (the basis output)
    __shared__ int s_ch[kK8Warps][3 * kMaxBasis];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int r = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    if (r >= p.B) return;  // the whole warp
    const Ray ray = load_ray(p, r);
    const int C = 3 * p.bd;
    // with the basis output lane j sums element j (+ 32 k) of the ray's
    // basis gradient over its channels
    if (kShMult)
        for (int j = lane; j < C; j += 32) s_ch[wib][j] = j / p.bd;
    float gshm_j[kRowChunks] = {};
    const int64_t n_sh = (int64_t)p.cap * C;  // g_sh's floats
    const int slots = (C + 6) / 4;  // float4 slots a row touches, at most
    const int rows_per = 32 / slots;
    // this lane's float4 slot of a row, and the channel and basis factor of
    // the 7 elements it can hold, j = 4 slot - 3 + u (u by the row's phase)
    const int slot = lane % slots;
    float fac7[7];
    unsigned ch7 = 0u;
#pragma unroll
    for (int u = 0; u < 7; ++u) {
        const int j = 4 * slot - 3 + u;
        const bool in_row = j >= 0 && j < C;
        fac7[u] = in_row ? ray.shm[j % p.bd] : 0.0f;
        ch7 |= (unsigned)(in_row ? j / p.bd : 0) << (2 * u);
    }
    RayGrad rg;
    for (int ch = 0; ch < 3; ++ch) rg.g[ch] = p.g_rgb[3 * (int64_t)r + ch];
    rg.g_depth = kOut && p.g_depth ? p.g_depth[r] : 0.0f;
    rg.g_log_T = kOut && p.g_log_T ? p.g_log_T[r] : 0.0f;
    // the suffix of w G over every entry above the group, from the background's
    float suffix = expf(p.log_T[r]) * bg_dot(p, r, rg.g);
    s_carry[wib][0][lane] = 0.0f;
    s_carry[wib][1][lane] = 0.0f;
    if (lane == 0) s_flip[wib][0] = s_flip[wib][1] = 0;
    __syncwarp();
    const int64_t e0 = p.offsets[r], e1 = p.offsets[r + 1];
    int in = 0;  // the buffer the group above wrote
    for (int64_t base = e1 > e0 ? e0 + (e1 - 1 - e0) / 32 * 32 : e0 - 1; base >= e0;
         base -= 32) {
        const int64_t e = base + lane;
        const bool valid = e < e1;
        Entry en;
        if (valid) en = load_entry(p, ray, e);
        CuvolCorners cs;
        gather_corners_warp(p, ray.shm, valid, en.l, cs, lane);
        float pre0 = 0.0f, A = 0.0f;
        if (valid) {
            pre0 = p.entry_pre[e];
            A = entry_weighted_grad<kOut>(p, ray, en, cs, pre0, rg);
        }
        // the suffix at each entry's end: the carried suffix plus the lanes above
        const float incl = warp_suffix(A, lane);
        const float above = __shfl_down_sync(kFullWarp, incl, 1);
        const float s_end = lane < 31 ? suffix + above : suffix;
        suffix = suffix + __shfl_sync(kFullWarp, incl, 0);
        float acc[8][4];
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[c][k] = 0.0f;
        if (valid) entry_corner_grads<kOut>(p, ray, en, cs, pre0, s_end, A, rg, acc);

        // Hand each corner's sums down the ray to the last entry below that
        // shares the vertex: a round moves every packet one lane down; lane
        // 0's packets leave for the group below, through shared memory.
        int flip = 0;
        unsigned shared = 0u;
        if (valid && e > e0) {
            const int lo[3] = {p.l[3 * (e - 1)], p.l[3 * (e - 1) + 1], p.l[3 * (e - 1) + 2]};
            shared = shared_corners(en.l, lo, cs.link, flip);
        }
        // one channel at a time (k: density, then the colours)
        const int out = in ^ 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float pk[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const bool sh = (shared >> c) & 1u;
                pk[c] = sh ? acc[c][k] : 0.0f;
                acc[c][k] = sh ? 0.0f : acc[c][k];
            }
            for (int hop = 0;; ++hop) {
                if (lane == 0) {
#pragma unroll
                    for (int c = 0; c < 8; ++c) s_carry[wib][out][4 * c + k] += pk[c];
                }
                float got[8];
#pragma unroll
                for (int c = 0; c < 8; ++c) got[c] = __shfl_down_sync(kFullWarp, pk[c], 1);
                int got_flip = __shfl_down_sync(kFullWarp, flip, 1);
                if (lane == 31) {
                    got_flip = s_flip[wib][in];
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                        got[c] = hop == 0 ? s_carry[wib][in][4 * c + k] : 0.0f;
                }
                flip_corners(got, got_flip);
                bool moving = false;
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    const bool sh = (shared >> c) & 1u;
                    pk[c] = sh ? got[c] : 0.0f;
                    if (!sh) acc[c][k] = acc[c][k] + got[c];
                    moving = moving || (sh && got[c] != 0.0f);
                }
                if (!__any_sync(kFullWarp, moving)) break;
            }
        }
        __syncwarp();
        s_carry[wib][in][lane] = 0.0f;  // read; the group below writes it next
        if (lane == 0) s_flip[wib][out] = flip;
        __syncwarp();
        in = out;

        // flush: the density sums by their lanes; then the warp lists the
        // SH rows to add in shared memory and adds them with float4 atomics
        int n_rows = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int link = cs.link[c];
            if (link >= 0 && acc[c][0] != 0.0f) atomicAdd(p.g_density + link, acc[c][0]);
            const bool want = link >= 0 && (acc[c][1] != 0.0f || acc[c][2] != 0.0f ||
                                            acc[c][3] != 0.0f);
            const unsigned m = __ballot_sync(kFullWarp, want);
            if (want) {
                const int i = n_rows + __popc(m & ((1u << lane) - 1u));
                s_link[wib][i] = link;
                for (int ch = 0; ch < 3; ++ch) s_gc[wib][i][ch] = acc[c][1 + ch];
            }
            n_rows += __popc(m);
        }
        __syncwarp();
        // a row's elements lie in slots of 4 aligned floats, `slots` lanes a
        // row, 32 / slots rows an instruction; elements of the rows beside
        // it in a slot add 0, and a slot past the end of g_sh adds element
        // by element
        for (int i0 = 0; i0 < n_rows; i0 += rows_per) {
            const int i = i0 + lane / slots;
            if (lane < rows_per * slots && i < n_rows) {
                const float g0 = s_gc[wib][i][0], g1 = s_gc[wib][i][1], g2 = s_gc[wib][i][2];
                const int64_t e_row = (int64_t)s_link[wib][i] * C;
                const int ph = (int)(e_row & 3);
                const int64_t a = e_row - ph + 4 * slot;
                float x[4];
                bool any = false;
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const float f = ph == 0 ? fac7[t + 3]
                                    : ph == 1 ? fac7[t + 2]
                                    : ph == 2 ? fac7[t + 1]
                                              : fac7[t];
                    const unsigned ch = (ch7 >> (2 * (t + 3 - ph))) & 3u;
                    x[t] = (ch == 0 ? g0 : (ch == 1 ? g1 : g2)) * f;
                    any = any || x[t] != 0.0f;
                }
                if (any && a + 4 <= n_sh) {
                    atomicAdd(reinterpret_cast<float4*>(p.g_sh + a),
                              make_float4(x[0], x[1], x[2], x[3]));
                } else if (any) {
                    for (int t = 0; t < 4; ++t)
                        if (x[t] != 0.0f) atomicAdd(p.g_sh + a + t, x[t]);
                }
            }
        }
        if (kShMult) {
            for (int i = 0; i < n_rows; ++i) {
                const int64_t row = (int64_t)s_link[wib][i] * C;
#pragma unroll
                for (int k = 0; k < kRowChunks; ++k) {
                    const int j = k * 32 + lane;
                    if (j < C) gshm_j[k] = gshm_j[k] + s_gc[wib][i][s_ch[wib][j]] * p.sh[row + j];
                }
            }
        }
        __syncwarp();
    }
    if (kShMult) {
        // the ray's basis gradient: element b sums its three channels' lanes
#pragma unroll
        for (int k = 0; k < kRowChunks; ++k) {
            const int j = k * 32 + lane;
            if (j < C) s_basis[wib][j] = gshm_j[k];
        }
        __syncwarp();
        if (lane < p.bd) {
            float v = s_basis[wib][lane];
            v = v + s_basis[wib][p.bd + lane];
            v = v + s_basis[wib][2 * p.bd + lane];
            p.g_sh_mult[(int64_t)r * p.bd + lane] = v;
        }
    }
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

static void launch_k8_backward(void (*kernel)(CuvolParams), const CuvolParams& p, void* stream) {
    kernel<<<(p.B + kK8Warps - 1) / kK8Warps, 32 * kK8Warps, 0, (cudaStream_t)stream>>>(p);
}

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
    cuvol_forward_kernel<<<(B + kK8Warps - 1) / kK8Warps, 32 * kK8Warps, 0,
                           (cudaStream_t)stream>>>(p);
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
                                      float* g_density, float* g_sh, float* g_sh_mult, int cap,
                                      void* stream) {
    if (B <= 0) return cudaSuccess;
    if (bd > kMaxBasis) return cudaErrorInvalidValue;  // the warp's SH row lanes
    if (reinterpret_cast<uintptr_t>(g_sh) % 16) return cudaErrorMisalignedAddress;  // float4 adds
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
    p.cap = cap;
    const bool out = g_depth || g_log_T;
    if (g_sh_mult && out)
        launch_k8_backward(cuvol_backward_kernel<true, true>, p, stream);
    else if (g_sh_mult)
        launch_k8_backward(cuvol_backward_kernel<true, false>, p, stream);
    else if (out)
        launch_k8_backward(cuvol_backward_kernel<false, true>, p, stream);
    else
        launch_k8_backward(cuvol_backward_kernel<false, false>, p, stream);
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
