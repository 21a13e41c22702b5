// K14: the compat marches "nvol" and "svox1", forward and backward.
//
// Replaces the JAX package's render/compat.py: volume_render_nvol (58) and
// volume_render_svox1 (115), two fixed-step lax.scan marches, and jax.grad
// of them. Both step every ray from its tmin by t = tmin + k * step (t
// formed per step, not accumulated), k < n_steps, and stop at the first
// t > tmax: t rises with k, so no later step is active, and JAX's inactive
// steps add nothing. A step is used where its sigma > sigma_thresh. There
// is no early stop on transmittance: JAX marches every step.
//
// - nvol (Neural Volumes' additive alpha, render_lerp_kernel_nvol.cu): the
//   sample is the edge-clamped trilerp of ops/trilerp.py:voxel_of (density
//   and the 3 bd SH coefficients, then contracted with the ray's basis);
//   inc = 1 - exp(-ws relu(sigma)), total = min(total + inc, 1), the
//   sample's weight the clamped increment, the background weighted by
//   1 - total.
// - svox1 (PlenOctrees' nearest neighbour): the origin is shifted by +0.5
//   (the caller's), the voxel is int(o + t d) truncated toward zero as
//   astype(int32) does, then clipped; standard exponential transmittance.
//
// compat_forward, one thread a ray: rgb, depth, and the per-ray
// accumulator (nvol: total alpha; svox1: log transmittance).
//
// compat_backward, one thread a ray, the cotangent of rgb, into the
// density and SH rows (atomics) and, with a g_sh_mult output, into the
// ray's basis (summed in registers, written once); its second
// instantiation (given g_depth or g_acc) also those of depth and acc (depth = sum w t adds
// g_depth t to each step's colour term G_k; nvol's total is the sum of the
// increments up to the saturating step, so without one g_acc joins G_ref
// with a minus sign; svox1's log T sums every step's log_att, so g_acc joins
// the suffix):
// - nvol: before the step s that saturates min(total + inc, 1), the
//   weights are the increments and d rgb.g / d inc_k = G_k - G_ref, with
//   G_k = g . c_k and G_ref = G_s (or g . bg when no step saturates); the
//   step s itself has weight 1 - total_{s-1} and no inc gradient, and the
//   steps after it weigh 0. A forward pass finds s, G_s and total_{s-1};
//   a second forward pass scatters. An exact tie total + inc == 1 is taken
//   as a saturation (JAX's minimum would pass half the gradient there).
// - svox1: d rgb.g / d log_att_k = -T_k exp(log_att_k) G_k + S_k, S_k the
//   suffix sum of w_j G_j over j > k plus T_final g . bg. A forward pass
//   keeps the prefix log T at every kSeg-th step (local memory); the
//   reverse pass recomputes each segment's prefixes forward from its
//   checkpoint, in the forward's order, so every T_k is the forward's bit
//   for bit and no derivative is a difference of totals.
//
// Bound: the gathers. nvol reads 8 links and 8 rows of 1 + 3 bd floats a
// step, svox1 one link and one row; ~886 steps a ray at 256^3 with step
// 0.5. Design: one thread a ray, no shared memory, as K10; the backward
// recomputes its samples rather than saving ~886 per ray.
#include "common.cuh"

constexpr int kMaxBasis = 32;  // widest basis of the g_sh_mult registers
constexpr int kSeg = 64;       // svox1 backward: steps between prefix checkpoints
constexpr int kMaxSeg = 128;   // so at most kSeg * kMaxSeg = 8192 steps a ray

struct CompatParams {
    int svox1;  // 0: nvol, 1: svox1
    int B;
    const float* origins;  // (B, 3) grid space (svox1: +0.5 already)
    const float* dirs;     // (B, 3) unit grid-space directions
    const float* sh_mult;  // (B, bd)
    int bd;
    const float* delta_scale;  // (B,)
    const float* tmin;
    const float* tmax;
    const int* links;
    int X, Y, Z;
    const float* density;  // (cap,)
    const float* sh;       // (cap, 3 bd)
    float step;
    int n_steps;
    float sigma_thresh, bg;
    float* rgb;    // (B, 3)
    float* depth;  // (B,)
    float* acc;    // (B,) nvol: total alpha; svox1: log T
    const float* g_rgb;  // (B, 3)
    float* g_density;    // (cap,)
    float* g_sh;         // (cap, 3 bd)
    float* g_sh_mult;    // (B, bd) or null
    const float* g_depth;  // (B,) or null (the second instantiation)
    const float* g_acc;    // (B,) or null: total alpha (nvol) or log T (svox1)
};

struct CRay {
    float o[3], d[3];
    float ws, tmin, tmax;
    const float* shm;
};

HD CRay load_cray(const CompatParams& p, int r) {
    CRay ray;
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

// one step's sample: nvol's 8 corners (weights w8) or svox1's one voxel
// (link[0], w8[0] = 1)
struct CSample {
    int n;  // corners: 8 (nvol) or 1 (svox1)
    int link[8];
    float w8[8];
    float sigma;   // before the relu
    float pre[3];  // the colour before max(., 0)
    bool use;      // sigma > sigma_thresh
};

HD const float* sh_row(const CompatParams& p, int link) {
    return p.sh + (int64_t)link * 3 * p.bd;
}

// the trilerped (or nearest) SH coefficient ch bd + b of the sample
HD float coef(const CompatParams& p, const CSample& s, int ch, int b) {
    float v = 0.0f;
    for (int c = 0; c < s.n; ++c) {
        const float x = s.link[c] >= 0 ? sh_row(p, s.link[c])[ch * p.bd + b] : 0.0f;
        v = c == 0 ? s.w8[0] * x : v + s.w8[c] * x;
    }
    return v;
}

HD void compat_sample(const CompatParams& p, const CRay& ray, float t, CSample& s) {
    const int dims[3] = {p.X, p.Y, p.Z};
    float pos[3];
    for (int a = 0; a < 3; ++a) pos[a] = ray.o[a] + t * ray.d[a];
    if (p.svox1) {
        int l[3];
        for (int a = 0; a < 3; ++a) l[a] = clampi((int)pos[a], 0, dims[a] - 1);
        s.n = 1;
        s.link[0] = p.links[((int64_t)l[0] * p.Y + l[1]) * p.Z + l[2]];
        s.w8[0] = 1.0f;
        s.sigma = s.link[0] >= 0 ? p.density[s.link[0]] : 0.0f;
    } else {
        // voxel_of: clip into [0, dim - 1], base voxel clipped to dim - 2
        int l[3];
        float f[3];
        for (int a = 0; a < 3; ++a) {
            const float pc = fminf(fmaxf(pos[a], 0.0f), (float)dims[a] - 1.0f);
            l[a] = clampi((int)pc, 0, dims[a] - 2);
            f[a] = pc - (float)l[a];
        }
        s.n = 8;
        trilerp_weights(f[0], f[1], f[2], s.w8);
        float dens[8];
        for (int c = 0; c < 8; ++c) {
            const int cx = clampi(l[0] + corner_dx(c), 0, p.X - 1);
            const int cy = clampi(l[1] + corner_dy(c), 0, p.Y - 1);
            const int cz = clampi(l[2] + corner_dz(c), 0, p.Z - 1);
            s.link[c] = p.links[((int64_t)cx * p.Y + cy) * p.Z + cz];
            dens[c] = s.link[c] >= 0 ? p.density[s.link[c]] : 0.0f;
        }
        s.sigma = corner_dot(s.w8, dens);
    }
    s.use = s.sigma > p.sigma_thresh;
    for (int ch = 0; ch < 3; ++ch) {
        float acc = ray.shm[0] * coef(p, s, ch, 0);
        for (int b = 1; b < p.bd; ++b) acc = acc + ray.shm[b] * coef(p, s, ch, b);
        s.pre[ch] = acc + 0.5f;
    }
}

// -ws relu(sigma) where used, else 0: svox1's log attenuation, and nvol's
// exponent of 1 - inc
HD float log_att(const CRay& ray, const CSample& s) {
    return s.use ? -ray.ws * fmaxf(s.sigma, 0.0f) : 0.0f;
}

HD float colour_dot(const float g[3], const CSample& s) {
    float acc = g[0] * fmaxf(s.pre[0], 0.0f);
    acc = acc + g[1] * fmaxf(s.pre[1], 0.0f);
    return acc + g[2] * fmaxf(s.pre[2], 0.0f);
}

HD void compat_forward_ray(const CompatParams& p, int r) {
    const CRay ray = load_cray(p, r);
    float acc = 0.0f, depth = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < p.n_steps; ++k) {
        const float t = ray.tmin + (float)k * p.step;
        if (!(t <= ray.tmax)) break;
        CSample s;
        compat_sample(p, ray, t, s);
        const float la = log_att(ray, s);
        float w;
        if (p.svox1) {
            w = expf(acc) * (1.0f - expf(la));
            acc = acc + la;
        } else {
            const float inc = s.use ? 1.0f - expf(la) : 0.0f;
            const float nt = fminf(acc + inc, 1.0f);
            w = nt - acc;
            acc = nt;
        }
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + w * fmaxf(s.pre[ch], 0.0f);
        depth = depth + w * t;
    }
    const float tb = p.svox1 ? expf(acc) : 1.0f - acc;
    for (int ch = 0; ch < 3; ++ch) p.rgb[3 * (int64_t)r + ch] = rgb[ch] + tb * p.bg;
    p.depth[r] = depth;
    p.acc[r] = acc;
}

// the row gradients of one sample from d sigma and the colour cotangents
// d_pre; the basis gradient into gshm
template <bool kShMult>
HD void scatter_sample(const CompatParams& p, const CRay& ray, const CSample& s, float d_sigma,
                       const float d_pre[3], float* gshm) {
    const int C = 3 * p.bd;
    for (int c = 0; c < s.n; ++c) {
        const int link = s.link[c];
        if (link < 0) continue;  // fetch_links' zero row takes no gradient
        const float gd = s.w8[c] * d_sigma;
        if (gd != 0.0f) atomic_add(p.g_density + link, gd);
        float* row = p.g_sh + (int64_t)link * C;
        for (int ch = 0; ch < 3; ++ch) {
            const float gc = s.w8[c] * d_pre[ch];
            if (gc == 0.0f) continue;
            for (int b = 0; b < p.bd; ++b) atomic_add(row + ch * p.bd + b, gc * ray.shm[b]);
        }
    }
    if (kShMult) {
        // not unrolled: the unrolled 32 x 3 x 8 loads doubled the build time
        for (int b = 0; b < p.bd; ++b) {
            float acc = gshm[b];
            for (int ch = 0; ch < 3; ++ch)
                if (d_pre[ch] != 0.0f) acc = acc + d_pre[ch] * coef(p, s, ch, b);
            gshm[b] = acc;
        }
    }
}

// the output cotangents of the second instantiation: depth's and acc's (0 where
// absent)
HD void out_cotangents(const CompatParams& p, int r, float& gd, float& ga) {
    gd = p.g_depth ? p.g_depth[r] : 0.0f;
    ga = p.g_acc ? p.g_acc[r] : 0.0f;
}

template <bool kShMult, bool kOut>
HD void nvol_backward_ray(const CompatParams& p, int r) {
    const CRay ray = load_cray(p, r);
    const float g[3] = {p.g_rgb[3 * (int64_t)r], p.g_rgb[3 * (int64_t)r + 1],
                        p.g_rgb[3 * (int64_t)r + 2]};
    float gd = 0.0f, ga = 0.0f;
    if constexpr (kOut) out_cotangents(p, r, gd, ga);
    float gshm[kMaxBasis];
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) gshm[b] = 0.0f;
    // pass 1: the saturating step s and H_s = G_s (+ g_depth t_s); without
    // one H_ref = g . bg (- g_acc: the total is the sum of the increments)
    int s_sat = -1, K = 0;
    float total = 0.0f, g_ref = p.bg * (g[0] + g[1] + g[2]);
    if constexpr (kOut) g_ref = g_ref - ga;
    for (int k = 0; k < p.n_steps; ++k) {
        const float t = ray.tmin + (float)k * p.step;
        if (!(t <= ray.tmax)) break;
        K = k + 1;
        if (s_sat >= 0) continue;
        CSample s;
        compat_sample(p, ray, t, s);
        const float inc = s.use ? 1.0f - expf(log_att(ray, s)) : 0.0f;
        if (total + inc >= 1.0f) {
            s_sat = k;
            g_ref = colour_dot(g, s);
            if constexpr (kOut) g_ref = g_ref + gd * t;
        }
        total = fminf(total + inc, 1.0f);
    }
    // pass 2: the steps up to s (all of them without one)
    const int k_end = s_sat >= 0 ? s_sat + 1 : K;
    total = 0.0f;
    for (int k = 0; k < k_end; ++k) {
        const float t = ray.tmin + (float)k * p.step;
        CSample s;
        compat_sample(p, ray, t, s);
        const float la = log_att(ray, s);
        const float inc = s.use ? 1.0f - expf(la) : 0.0f;
        const float nt = fminf(total + inc, 1.0f);
        const float w = nt - total;
        total = nt;
        float h = colour_dot(g, s);
        if constexpr (kOut) h = h + gd * t;
        const float d_inc = k == s_sat ? 0.0f : h - g_ref;
        // inc = 1 - exp(-ws relu(sigma)): d inc / d sigma = ws exp(la) where sigma > 0
        const float d_sigma = (s.use && s.sigma > 0.0f) ? d_inc * (ray.ws * expf(la)) : 0.0f;
        float d_pre[3];
        for (int ch = 0; ch < 3; ++ch) d_pre[ch] = w * g[ch] * clip_lo_grad(s.pre[ch], 0.0f);
        scatter_sample<kShMult>(p, ray, s, d_sigma, d_pre, gshm);
    }
    if (kShMult) {
#pragma unroll
        for (int b = 0; b < kMaxBasis; ++b)
            if (b < p.bd) p.g_sh_mult[(int64_t)r * p.bd + b] = gshm[b];
    }
}

template <bool kShMult, bool kOut>
HD void svox1_backward_ray(const CompatParams& p, int r) {
    const CRay ray = load_cray(p, r);
    const float g[3] = {p.g_rgb[3 * (int64_t)r], p.g_rgb[3 * (int64_t)r + 1],
                        p.g_rgb[3 * (int64_t)r + 2]};
    float gd = 0.0f, ga = 0.0f;
    if constexpr (kOut) out_cotangents(p, r, gd, ga);
    float gshm[kMaxBasis];
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) gshm[b] = 0.0f;
    // pass 1: the prefix log T at every kSeg-th step, and the final one
    float ckpt[kMaxSeg];
    float log_T = 0.0f;
    int K = 0;
    for (int k = 0; k < p.n_steps; ++k) {
        const float t = ray.tmin + (float)k * p.step;
        if (!(t <= ray.tmax)) break;
        if (k % kSeg == 0) ckpt[k / kSeg] = log_T;
        CSample s;
        compat_sample(p, ray, t, s);
        log_T = log_T + log_att(ray, s);
        K = k + 1;
    }
    // the suffix: every later step's w G plus the background's T_final g . bg
    // (and log T's own cotangent, which every step's log_att joins)
    float suffix = expf(log_T) * (p.bg * (g[0] + g[1] + g[2]));
    if constexpr (kOut) suffix = suffix + ga;
    float pre[kSeg], la[kSeg];
    for (int seg = (K - 1) / kSeg; seg >= 0 && K > 0; --seg) {
        const int k0 = seg * kSeg, k1 = k0 + kSeg < K ? k0 + kSeg : K;
        float run = ckpt[seg];
        for (int k = k0; k < k1; ++k) {  // the forward's prefixes, in its order
            CSample s;
            compat_sample(p, ray, ray.tmin + (float)k * p.step, s);
            pre[k - k0] = run;
            la[k - k0] = log_att(ray, s);
            run = run + la[k - k0];
        }
        for (int k = k1 - 1; k >= k0; --k) {
            CSample s;
            const float t = ray.tmin + (float)k * p.step;
            compat_sample(p, ray, t, s);
            const float T = expf(pre[k - k0]);
            const float ea = expf(la[k - k0]);
            const float w = T * (1.0f - ea);
            float G = colour_dot(g, s);
            if constexpr (kOut) G = G + gd * t;  // depth = sum w t
            const float d_la = -T * ea * G + suffix;
            suffix = suffix + w * G;
            const float d_sigma = (s.use && s.sigma > 0.0f) ? -ray.ws * d_la : 0.0f;
            float d_pre[3];
            for (int ch = 0; ch < 3; ++ch) d_pre[ch] = w * g[ch] * clip_lo_grad(s.pre[ch], 0.0f);
            scatter_sample<kShMult>(p, ray, s, d_sigma, d_pre, gshm);
        }
    }
    if (kShMult) {
#pragma unroll
        for (int b = 0; b < kMaxBasis; ++b)
            if (b < p.bd) p.g_sh_mult[(int64_t)r * p.bd + b] = gshm[b];
    }
}

#ifdef __CUDACC__
__global__ void compat_forward_kernel(CompatParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) compat_forward_ray(p, r);
}

template <bool kShMult, bool kOut>
__global__ void compat_backward_kernel(CompatParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= p.B) return;
    if (p.svox1)
        svox1_backward_ray<kShMult, kOut>(p, r);
    else
        nvol_backward_ray<kShMult, kOut>(p, r);
}

static const int kBlock = 128;

static CompatParams make_compat(int svox1, int B, const float* origins, const float* dirs,
                                const float* sh_mult, int bd, const float* delta_scale,
                                const float* tmin, const float* tmax, const int* links, int X,
                                int Y, int Z, const float* density, const float* sh, float step,
                                int n_steps, float sigma_thresh, float bg) {
    CompatParams p{};
    p.svox1 = svox1;
    p.B = B;
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
    p.n_steps = n_steps;
    p.sigma_thresh = sigma_thresh;
    p.bg = bg;
    return p;
}

extern "C" cudaError_t compat_forward(int svox1, int B, const float* origins, const float* dirs,
                                      const float* sh_mult, int bd, const float* delta_scale,
                                      const float* tmin, const float* tmax, const int* links,
                                      int X, int Y, int Z, const float* density, const float* sh,
                                      float step, int n_steps, float sigma_thresh, float bg,
                                      float* rgb, float* depth, float* acc, void* stream) {
    if (B <= 0) return cudaSuccess;
    CompatParams p = make_compat(svox1, B, origins, dirs, sh_mult, bd, delta_scale, tmin, tmax,
                                 links, X, Y, Z, density, sh, step, n_steps, sigma_thresh, bg);
    p.rgb = rgb;
    p.depth = depth;
    p.acc = acc;
    compat_forward_kernel<<<(B + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}

// the cotangent of rgb (B, 3), and of depth and acc (B,) (each null when
// absent: both null choose the rgb-only instantiation)
extern "C" cudaError_t compat_backward(int svox1, int B, const float* origins, const float* dirs,
                                       const float* sh_mult, int bd, const float* delta_scale,
                                       const float* tmin, const float* tmax, const int* links,
                                       int X, int Y, int Z, const float* density,
                                       const float* sh, float step, int n_steps,
                                       float sigma_thresh, float bg, const float* g_rgb,
                                       float* g_density, float* g_sh, float* g_sh_mult,
                                       const float* g_depth, const float* g_acc, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (svox1 && n_steps > kSeg * kMaxSeg) return cudaErrorInvalidValue;
    if (g_sh_mult && bd > kMaxBasis) return cudaErrorInvalidValue;
    CompatParams p = make_compat(svox1, B, origins, dirs, sh_mult, bd, delta_scale, tmin, tmax,
                                 links, X, Y, Z, density, sh, step, n_steps, sigma_thresh, bg);
    p.g_rgb = g_rgb;
    p.g_density = g_density;
    p.g_sh = g_sh;
    p.g_sh_mult = g_sh_mult;
    p.g_depth = g_depth;
    p.g_acc = g_acc;
    const unsigned grid = (B + kBlock - 1) / kBlock;
    const cudaStream_t st = (cudaStream_t)stream;
    if (g_depth || g_acc) {
        if (g_sh_mult)
            compat_backward_kernel<true, true><<<grid, kBlock, 0, st>>>(p);
        else
            compat_backward_kernel<false, true><<<grid, kBlock, 0, st>>>(p);
    } else if (g_sh_mult) {
        compat_backward_kernel<true, false><<<grid, kBlock, 0, st>>>(p);
    } else {
        compat_backward_kernel<false, false><<<grid, kBlock, 0, st>>>(p);
    }
    return cudaGetLastError();
}
#endif
