// K9c weight march, K9d surface visibility walk and K9e transmittance
// march: the camera sweeps of the stage transitions.
//
// K9c replaces the JAX package's core/weight_render.py:_dense_weight_chunk
// (97) / grid_weight_render (129), svox2's misc_kernel.cu grid weight
// render: every camera ray marches a dense density volume at the new
// resolution with a fixed step, t = tmin + k step for k < n_steps while
// t <= tmax and the transmittance is >= stop_thresh; a sample with
// sigma > 1e-8 has weight T (1 - exp(-world_step sigma)), and each voxel
// keeps the largest weight of any sample in it, at its 8 corners. JAX scans
// a fixed n_steps and writes max(., 0) at inactive steps; a per-ray loop
// that stops at tmax or below stop_thresh gives the same maxima, since the
// transmittance only falls. The ray set-up (grid transform, slab bounds on
// [-0.5, size - 0.5], tmin >= 0, caps at 2e3) is computed outside the
// kernel, once, for the kernel and its plain version alike. The maximum
// is an atomicMax on the int bits of the weight, which orders as the float
// for the non-negative weights; zero weights are not written.
// Bound: the march is latency-bound on its 8 gathers a sample (the volume,
// 67 MB at 256^3, 537 MB at 512^3, is read from L2 or HBM as the rays
// pass); the least work is the volume read once and the weights written
// once, or about 25 float operations a sample. One thread per ray.
//
// K9d replaces core/weight_render.py:_visibility_chunk (270) /
// sparse_grid_visibility_render_surf (329), svox2's misc_kernel.cu
// visibility render: each ray walks its voxels in t order, the segments
// between tnear and the interior plane crossings in (tnear + 1e-9,
// tmax - 1e-9) as JAX's render/surface.py:all_crossings lists them after
// its sort, each segment's voxel the floor of its midpoint; it adds 1 to
// every present corner link of every valid in-lattice segment up to and
// including the first one holding a surface hit: all 8 corners present,
// a level set within the corners' surface range, and a root > 0 of the
// trilinear cubic (origin max(seg_start, 0)) whose point lies in the closed
// unit cube of the voxel. The walk merges the three axis-plane sequences,
// each monotone in t, computing each crossing as (plane - o) / d as the
// plain version does, so the segments are the sorted list's exactly. The
// cubic is samples.cuh's (Vieta with two Newton steps, ops/cubic.py).
// Counts are int32 atomics, exact. Bound: operations, about 30 for each
// plane crossed plus about 600 for each cubic solved; one thread per ray.
//
// K9e replaces core/weight_render.py:_sparse_transmit_chunk (160) /
// sparse_grid_weight_render (207), svox2's misc_kernel.cu sparse grid
// weight render (surf_init_type "weight"): K9c's march, from t = 0 on the
// slab [-0.5, size - 0.5] of the sparse grid's own lattice, reading the raw
// density of the 8 corner links (0 where a link is empty, no relu) summed
// in JAX's corner order; at every sample with sigma > 1e-8 each present
// corner keeps the largest transmittance before the sample, an atomicMax
// on its bits (T >= 0). JAX pads its last ray chunk with copies of the last
// ray, which a maximum does not see, so the result is JAX's. Bound: as
// K9c, latency on the gathers of one thread per ray.
#include <cstring>

#include "samples.cuh"

// atomic add and max on the device; plain ones when the per-thread code
// runs on the host
HD void atomic_add_int(int* p, int v) {
#ifdef __CUDA_ARCH__
    atomicAdd(p, v);
#else
    *p += v;
#endif
}

HD void atomic_max_int(int* p, int v) {
#ifdef __CUDA_ARCH__
    atomicMax(p, v);
#else
    if (v > *p) *p = v;
#endif
}

// the bits of a float as an int; for non-negative floats they order as the
// floats do
HD int float_bits(float w) {
#ifdef __CUDA_ARCH__
    return __float_as_int(w);
#else
    int b;
    std::memcpy(&b, &w, sizeof b);
    return b;
#endif
}

struct SweepRays {
    const float* o;
    const float* d;
    const float* t0;  // tmin (K9c) or tnear (K9d)
    const float* t1;  // tmax
};

// the voxel l and fraction fr of the sample o + t d, clipped to the lattice
// (the JAX package's _voxel_and_frac)
HD void sample_voxel(const float o[3], const float d[3], float t, const int size[3], int l[3],
                     float fr[3]) {
    for (int a = 0; a < 3; ++a) {
        float p = o[a] + t * d[a];
        p = fminf(fmaxf(p, 0.0f), (float)size[a] - 1.0f);
        const int li = (int)p;
        l[a] = li < size[a] - 2 ? li : size[a] - 2;
        fr[a] = p - (float)l[a];
    }
}

// the trilinear weight of corner c at fraction fr, in JAX's product order
HD float corner_weight(int c, const float fr[3]) {
    return ((corner_dx(c) ? fr[0] : 1.0f - fr[0]) * (corner_dy(c) ? fr[1] : 1.0f - fr[1])) *
           (corner_dz(c) ? fr[2] : 1.0f - fr[2]);
}

// the trilinear density of the dense volume at the sample, summed in corner
// order; l is its voxel
HD float march_sigma(const float* vol, const int size[3], const float o[3], const float d[3],
                     float t, int l[3]) {
    float fr[3];
    sample_voxel(o, d, t, size, l, fr);
    const int64_t base = ((int64_t)l[0] * size[1] + l[1]) * size[2] + l[2];
    float acc = 0.0f;
    for (int c = 0; c < 8; ++c) {
        const float v = vol[base + ((int64_t)corner_dx(c) * size[1] + corner_dy(c)) * size[2] +
                            corner_dz(c)];
        acc = c == 0 ? corner_weight(c, fr) * v : acc + corner_weight(c, fr) * v;
    }
    return acc;
}

// the surface-hit test of one voxel whose 8 corners are present
HD bool voxel_has_hit(const float s8[8], const float o[3], const float d[3], const int l[3],
                      float seg_start, const float* lvs, int n_lv) {
    float smin = s8[0], smax = s8[0];
    for (int c = 1; c < 8; ++c) {
        smin = fminf(smin, s8[c]);
        smax = fmaxf(smax, s8[c]);
    }
    const float ts = fmaxf(seg_start, 0.0f);
    float u[3];
    for (int a = 0; a < 3; ++a) u[a] = o[a] + ts * d[a] - (float)l[a];
    float f[4];
    cubic_coeffs(s8, u, d, f);
    for (int i = 0; i < n_lv; ++i) {
        const float lv = lvs[i];
        if (!(lv >= smin && lv <= smax)) continue;
        float r[3];
        bool has[3];
        cubic_roots(f[0] - lv, f[1], f[2], f[3], r, has);
        for (int j = 0; j < 3; ++j) {
            if (!(r[j] > 0.0f)) continue;
            const float tr = ts + r[j];
            bool in_cube = true;
            for (int a = 0; a < 3; ++a) {
                const float fr = o[a] + tr * d[a] - (float)l[a];
                in_cube = in_cube && fr >= 0.0f && fr <= 1.0f;
            }
            if (in_cube) return true;
        }
    }
    return false;
}

// One segment [start, end] of a ray: count its corners if it is a valid
// in-lattice segment; returns true when it holds a hit (the walk stops).
HD bool visit_segment(const int* links, const int reso[3], const float* surf, const float* lvs,
                      int n_lv, const float o[3], const float d[3], float start, float end,
                      int* counts) {
    if (!(finite(start) && finite(end) && end > start + 1e-9f)) return false;
    const float tmid = 0.5f * (start + end);
    int l[3];
    for (int a = 0; a < 3; ++a) {
        l[a] = (int)floorf(o[a] + tmid * d[a]);
        if (l[a] < 0 || l[a] > reso[a] - 2) return false;
    }
    int lk[8];
    bool all = true;
    for (int c = 0; c < 8; ++c) {
        lk[c] = links[((int64_t)(l[0] + corner_dx(c)) * reso[1] + l[1] + corner_dy(c)) * reso[2] +
                      l[2] + corner_dz(c)];
        all = all && lk[c] >= 0;
    }
    for (int c = 0; c < 8; ++c)
        if (lk[c] >= 0) atomic_add_int(counts + lk[c], 1);
    if (!all) return false;
    float s8[8];
    for (int c = 0; c < 8; ++c) s8[c] = surf[lk[c]];
    return voxel_has_hit(s8, o, d, l, start, lvs, n_lv);
}

HD float cross_t(int q, float o, float d) { return ((float)q - o) / d; }

// K9d's walk of ray r: the segment starts in t order, as the sorted list
HD void visibility_ray(const SweepRays& R, int r, const int* links, const int reso[3],
                       const float* surf, const float* lvs, int n_lv, int* counts) {
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = R.o[3 * (int64_t)r + a];
        d[a] = R.d[3 * (int64_t)r + a];
    }
    const float tn = R.t0[r], tx = R.t1[r];
    const float lo = tn + 1e-9f, hi = tx - 1e-9f;
    int q[3], step[3];
    float tq[3];
    bool live[3];
    for (int a = 0; a < 3; ++a) {
        live[a] = false;
        const int pmax = reso[a] - 2;
        if (d[a] == 0.0f || pmax < 1) continue;
        const float pos0 = o[a] + tn * d[a];
        const float guess = d[a] > 0.0f ? floorf(pos0) : ceilf(pos0);
        int k = (int)fminf(fmaxf(guess, 1.0f), (float)pmax);
        if (d[a] > 0.0f) {
            step[a] = 1;
            while (k > 1 && cross_t(k - 1, o[a], d[a]) > lo) --k;
            while (k <= pmax && !(cross_t(k, o[a], d[a]) > lo)) ++k;
            if (k > pmax) continue;
        } else {
            step[a] = -1;
            while (k < pmax && cross_t(k + 1, o[a], d[a]) > lo) ++k;
            while (k >= 1 && !(cross_t(k, o[a], d[a]) > lo)) --k;
            if (k < 1) continue;
        }
        const float t = cross_t(k, o[a], d[a]);
        if (!(t < hi)) continue;
        q[a] = k;
        tq[a] = t;
        live[a] = true;
    }
    float start = tn;
    while (true) {
        int a = -1;
        for (int k = 0; k < 3; ++k)
            if (live[k] && (a < 0 || tq[k] < tq[a])) a = k;
        if (a < 0) break;
        const float next = tq[a];
        if (visit_segment(links, reso, surf, lvs, n_lv, o, d, start, fminf(next, tx), counts))
            return;
        start = next;
        const int k = q[a] + step[a];
        if (k < 1 || k > reso[a] - 2) {
            live[a] = false;
            continue;
        }
        const float tk = cross_t(k, o[a], d[a]);
        if (!(tk < hi)) {
            live[a] = false;
            continue;
        }
        q[a] = k;
        tq[a] = tk;
    }
    visit_segment(links, reso, surf, lvs, n_lv, o, d, start, tx, counts);
}

// K9c's march of ray r, raising wt (the bits of the weights) in place
HD void weight_march_ray(const SweepRays& R, const float* ws, int r, const float* vol,
                         const int size[3], float step, float stop_thresh, int n_steps, int* wt) {
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = R.o[3 * (int64_t)r + a];
        d[a] = R.d[3 * (int64_t)r + a];
    }
    const float tmin = R.t0[r], tmax = R.t1[r], world_step = ws[r];
    float log_T = 0.0f;
    for (int k = 0; k < n_steps; ++k) {
        const float t = tmin + (float)k * step;
        if (!(t <= tmax)) break;
        const float T = expf(log_T);
        if (!(T >= stop_thresh)) break;
        int l[3];
        const float sigma = march_sigma(vol, size, o, d, t, l);
        if (!(sigma > 1e-8f)) continue;
        const float log_att = -world_step * sigma;
        const float w = T * (1.0f - expf(log_att));
        log_T = log_T + log_att;
        if (!(w > 0.0f)) continue;
        const int bits = float_bits(w);
        const int64_t base = ((int64_t)l[0] * size[1] + l[1]) * size[2] + l[2];
        for (int c = 0; c < 8; ++c)
            atomic_max_int(wt + base + ((int64_t)corner_dx(c) * size[1] + corner_dy(c)) * size[2] +
                               corner_dz(c),
                           bits);
    }
}

// K9e's march of ray r through the sparse grid, raising out (the bits of the
// transmittances, one per row) at the present corners of every hit sample
HD void transmit_march_ray(const SweepRays& R, const float* ws, int r, const int* links,
                           const float* dens, const int size[3], float step, float stop_thresh,
                           int n_steps, int* out) {
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = R.o[3 * (int64_t)r + a];
        d[a] = R.d[3 * (int64_t)r + a];
    }
    const float tmin = R.t0[r], tmax = R.t1[r], world_step = ws[r];
    float log_T = 0.0f;
    for (int k = 0; k < n_steps; ++k) {
        const float t = tmin + (float)k * step;
        if (!(t <= tmax)) break;
        const float T = expf(log_T);
        if (!(T >= stop_thresh)) break;
        int l[3];
        float fr[3];
        sample_voxel(o, d, t, size, l, fr);
        int lk[8];
        float acc = 0.0f;
        for (int c = 0; c < 8; ++c) {
            lk[c] = links[((int64_t)(l[0] + corner_dx(c)) * size[1] + l[1] + corner_dy(c)) *
                              size[2] +
                          l[2] + corner_dz(c)];
            const float v = corner_weight(c, fr) * (lk[c] >= 0 ? dens[lk[c]] : 0.0f);
            acc = c == 0 ? v : acc + v;
        }
        if (!(acc > 1e-8f)) continue;
        const int bits = float_bits(T);
        for (int c = 0; c < 8; ++c)
            if (lk[c] >= 0) atomic_max_int(out + lk[c], bits);
        log_T = log_T - world_step * acc;
    }
}

#ifdef __CUDACC__
__global__ void transmit_march_kernel(SweepRays R, const float* ws, int B, const int* links,
                                      const float* dens, int X, int Y, int Z, float step,
                                      float stop_thresh, int n_steps, int* out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const int size[3] = {X, Y, Z};
    transmit_march_ray(R, ws, r, links, dens, size, step, stop_thresh, n_steps, out);
}

extern "C" cudaError_t transmit_march(const float* o, const float* d, const float* ws,
                                      const float* tmin, const float* tmax, int B,
                                      const int* links, const float* dens, int X, int Y, int Z,
                                      float step, float stop_thresh, int n_steps, int* out,
                                      void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    transmit_march_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        SweepRays{o, d, tmin, tmax}, ws, B, links, dens, X, Y, Z, step, stop_thresh, n_steps, out);
    return cudaGetLastError();
}

__global__ void weight_march_kernel(SweepRays R, const float* ws, int B, const float* vol, int X,
                                    int Y, int Z, float step, float stop_thresh, int n_steps,
                                    int* wt) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const int size[3] = {X, Y, Z};
    weight_march_ray(R, ws, r, vol, size, step, stop_thresh, n_steps, wt);
}

__global__ void visibility_kernel(SweepRays R, int B, const int* links, int X, int Y, int Z,
                                  const float* surf, const float* lvs, int n_lv, int* counts) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const int reso[3] = {X, Y, Z};
    visibility_ray(R, r, links, reso, surf, lvs, n_lv, counts);
}

extern "C" cudaError_t weight_march(const float* o, const float* d, const float* ws,
                                    const float* tmin, const float* tmax, int B, const float* vol,
                                    int X, int Y, int Z, float step, float stop_thresh,
                                    int n_steps, int* wt, void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    weight_march_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        SweepRays{o, d, tmin, tmax}, ws, B, vol, X, Y, Z, step, stop_thresh, n_steps, wt);
    return cudaGetLastError();
}

extern "C" cudaError_t visibility(const float* o, const float* d, const float* tnear,
                                  const float* tmax, int B, const int* links, int X, int Y, int Z,
                                  const float* surf, const float* lvs, int n_lv, int* counts,
                                  void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    visibility_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        SweepRays{o, d, tnear, tmax}, B, links, X, Y, Z, surf, lvs, n_lv, counts);
    return cudaGetLastError();
}
#endif
