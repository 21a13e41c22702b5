// Shared helpers of the port's kernels.
//
// Each kernel's per-thread work is a HD (host + device) function, and the
// __global__ wrapper and the plain-C launcher are compiled only by nvcc.
// The sources are built with --fmad=false: the plain PyTorch versions round
// every product before the following add, and phase A's corner-crossing
// tie rules need the same rounding to stay exact (see phase_a.cu).
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

// division guard of the JAX package: a zero direction component becomes 1e-12
HD float safe_dir(float d) { return d == 0.0f ? 1e-12f : d; }

HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// false for +-inf and NaN
HD bool finite(float x) { return fabsf(x) < INFINITY; }

// corner c of a voxel in reference order (z fastest): offset along x, y, z
HD int corner_dx(int c) { return c >> 2; }
HD int corner_dy(int c) { return (c >> 1) & 1; }
HD int corner_dz(int c) { return c & 1; }

// trilinear corner weights at fractional position (x, y, z)
HD void trilerp_weights(float x, float y, float z, float w[8]) {
    const float ix = 1.0f - x, iy = 1.0f - y, iz = 1.0f - z;
    w[0] = ix * iy * iz;
    w[1] = ix * iy * z;
    w[2] = ix * y * iz;
    w[3] = ix * y * z;
    w[4] = x * iy * iz;
    w[5] = x * iy * z;
    w[6] = x * y * iz;
    w[7] = x * y * z;
}

// sum_k w[k] * v[k] in corner order
HD float corner_dot(const float w[8], const float v[8]) {
    float acc = w[0] * v[0];
    for (int k = 1; k < 8; ++k) acc = acc + w[k] * v[k];
    return acc;
}

// The corners of voxel l that are also corners of voxel lo, the entry
// before it on the ray, as a bit set (present links only), and the XOR
// `flip` that takes a corner index of l to the same vertex's index in lo:
// the axes where the two voxels differ. Consecutive entries are face
// neighbours in the walk (4 shared corners) unless unoccupied voxels lie
// between them (an edge or vertex, or none).
HD unsigned shared_corners(const int l[3], const int lo[3], const int link[8], int& flip) {
    flip = 0;
    int need[3];  // the offset a shared corner has on each axis, -1: either
    for (int a = 0; a < 3; ++a) {
        const int d = l[a] - lo[a];
        if (d < -1 || d > 1) return 0u;
        need[a] = d == 0 ? -1 : (d > 0 ? 0 : 1);
        if (d != 0) flip |= 4 >> a;
    }
    unsigned set = 0u;
    for (int c = 0; c < 8; ++c) {
        const int o[3] = {corner_dx(c), corner_dy(c), corner_dz(c)};
        bool ok = link[c] >= 0;
        for (int a = 0; a < 3; ++a) ok = ok && (need[a] < 0 || o[a] == need[a]);
        if (ok) set |= 1u << c;
    }
    return set;
}

// truncated-vol-render cosine ramp at running intersection index ids
// (surface.py:trunc_vol_render_rw)
HD float trunc_rw(int ids, float a, float wmin) {
    const float x = fminf(fmaxf(a - (float)ids, 0.0f), 1.0f);
    const float pi = 3.14159265358979323846f;
    return fmaxf(0.5f * (1.0f - cosf(pi * x)), wmin);
}

// the compositor's clamp of 1 - alpha
HD float one_minus(float a) {
    return fminf(fmaxf(1.0f - a, 1e-7f), 1.0f - 1e-7f);
}

// Derivative factor of jnp.clip (a maximum, then a minimum): 1 strictly
// inside, 0 outside, and 1/2 at an exact tie, where JAX's maximum and
// minimum split the gradient between their two arguments.
HD float clip_grad(float x, float lo, float hi) {
    return (x > lo && x < hi) ? 1.0f : ((x == lo || x == hi) ? 0.5f : 0.0f);
}

HD float clip_lo_grad(float x, float lo) {
    return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}

// jax.nn.softplus, logaddexp(x, 0), in torch.logaddexp's arithmetic
HD float softplus_f(float x) { return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))); }

// its derivative, the logistic sigmoid, as logaddexp's: exp(x - softplus(x))
HD float softplus_grad(float x) { return expf(x - softplus_f(x)); }

// K4's lanes a ray (composite.cu), and K5a's (backward.cu), which takes
// K4's stop_thresh kill and picks with K4's scans in K4's groups of entries
constexpr int kK4Lanes = 16;

// atomic add on the device; a plain add when the per-thread code runs on
// the host
HD void atomic_add(float* p, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(p, v);
#else
    *p += v;
#endif
}

#ifdef __CUDACC__
constexpr unsigned kFullWarp = 0xffffffffu;

// Scans and reductions over segments of W consecutive lanes (W a power of
// two up to 32; W = 32 the whole warp): every lane of the warp calls them,
// lane is this lane's index within its segment. A segment never reads
// another's values (the shuffles' width argument).

// inclusive prefix sum over the segment's lanes below and at this one
template <int W = 32, typename T>
__device__ __forceinline__ T warp_prefix(T v, int lane) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const T u = __shfl_up_sync(kFullWarp, v, d, W);
        if (lane >= d) v = v + u;
    }
    return v;
}

// inclusive suffix sum over this lane and the segment's lanes above it
template <int W = 32, typename T>
__device__ __forceinline__ T warp_suffix(T v, int lane) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const T u = __shfl_down_sync(kFullWarp, v, d, W);
        if (lane + d < W) v = v + u;
    }
    return v;
}

// the sum over the segment, the same bits in every lane (each butterfly
// step adds the same two partial sums in both partners)
template <int W = 32, typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
    for (int d = W / 2; d > 0; d >>= 1) v = v + __shfl_xor_sync(kFullWarp, v, d, W);
    return v;
}

template <int W = 32>
__device__ __forceinline__ float warp_allmin(float v) {
#pragma unroll
    for (int d = W / 2; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(kFullWarp, v, d, W));
    return v;
}

// the exclusive prefix from the inclusive one: the lane below's value, 0
// in the segment's first lane (never a difference of two sums)
template <int W = 32, typename T>
__device__ __forceinline__ T warp_exclusive(T incl, int lane) {
    const T below = __shfl_up_sync(kFullWarp, incl, 1, W);
    return lane > 0 ? below : T(0);
}

// the segment's total from the inclusive prefix: its last lane's value
template <int W = 32, typename T>
__device__ __forceinline__ T warp_total(T incl) {
    return __shfl_sync(kFullWarp, incl, W - 1, W);
}

// the exclusive suffix from the inclusive one: the lane above's value, 0
// in the segment's last lane
template <int W = 32, typename T>
__device__ __forceinline__ T warp_exclusive_suffix(T incl, int lane) {
    const T above = __shfl_down_sync(kFullWarp, incl, 1, W);
    return lane + 1 < W ? above : T(0);
}

// the segment's total from the inclusive suffix: its first lane's value
template <int W = 32, typename T>
__device__ __forceinline__ T warp_suffix_total(T incl) {
    return __shfl_sync(kFullWarp, incl, 0, W);
}

// this segment's W bits of a warp ballot, lane 0 of the segment in bit 0
template <int W = 32>
__device__ __forceinline__ unsigned segment_bits(unsigned ballot, int warp_lane) {
    return W == 32 ? ballot : (ballot >> (warp_lane & ~(W - 1))) & ((1u << (W & 31)) - 1u);
}

// v[c] <- v[c ^ flip] for every corner c (a permutation: one swap per axis)
__device__ __forceinline__ void flip_corners(float v[8], int flip) {
#pragma unroll
    for (int bit = 1; bit < 8; bit <<= 1) {
        if (flip & bit) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                if (c & bit) continue;
                const float x = v[c];
                v[c] = v[c | bit];
                v[c | bit] = x;
            }
        }
    }
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// sum of v over the block, added to *out by one atomic in double, so that
// the sum over many blocks does not drift; every thread of the block must
// call it (blockDim.x a multiple of 32, at most 1024)
__device__ __forceinline__ void block_sum_atomic(float v, double* out) {
    __shared__ float part[32];
    v = warp_sum(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
        v = warp_sum(v);
        if (lane == 0 && v != 0.0f) atomicAdd(out, (double)v);
    }
}
#endif
