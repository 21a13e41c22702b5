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
