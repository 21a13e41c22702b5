// K7: masked RMSprop over one parameter group, in place.
//
// Replaces the JAX package's optim/rmsprop.py:rmsprop_step (26-45) with
// what train/steps.py:374-400 does around it: the clip of the surface
// gradient to +-surf_grad_abs_max, the row mask any(grad != 0) (and, for the
// surface, the surface_unfrozen gate), the rms and parameter update, and
// the floor on fake_sample_std. A row whose gradient is all zero keeps its
// parameter and its rms, as svox2's sparse indexer does.
//
// Bound: bytes. Each element's parameter, gradient and rms are read once,
// the parameter and rms written once: 20 bytes an element, 1.4 GB for the
// 2.47M-row grid of the main path. Design: rows of up to 4 channels take a
// thread each; wider rows (the 27 SH channels, the learned basis MLP's 64)
// a warp each, lane c on channels c, c + 32, ..., so that loads are
// coalesced and the row mask is one __any_sync. The learned bases' groups
// come as rows too: the texture's (R^3, bd) cells, each weight matrix's
// rows, and a bias as one row, as JAX's mask any(grad != 0, axis=-1)
// treats a 1-D array. The update is written in place, where JAX returns
// new arrays (and donates the old ones).
#include "common.cuh"

struct RMSParams {
    float* param;  // (rows, C)
    float* rms;    // (rows, C)
    const float* grad;
    int64_t rows;
    int C;
    float lr, beta, one_m_beta, eps;
    int has_clip;
    float clip;
    int has_min;
    float minval;
    int frozen;
};

HD void rmsprop_elem(const RMSParams& p, int64_t i, bool step) {
    if (!step) {
        // the floor applies to every row, as jnp.maximum after the where
        if (p.has_min) p.param[i] = fmaxf(p.param[i], p.minval);
        return;
    }
    float gi = p.grad[i];
    if (p.has_clip) gi = fminf(fmaxf(gi, -p.clip), p.clip);
    const float nr = p.beta * p.rms[i] + p.one_m_beta * gi * gi;
    const float upd = p.lr * gi / (sqrtf(nr) + p.eps);
    float np = p.param[i] - upd;
    if (p.has_min) np = fmaxf(np, p.minval);
    p.rms[i] = nr;
    p.param[i] = np;
}

HD void rmsprop_row(const RMSParams& p, int64_t r) {
    bool any = false;
    for (int c = 0; c < p.C; ++c) any = any || p.grad[r * p.C + c] != 0.0f;
    for (int c = 0; c < p.C; ++c) rmsprop_elem(p, r * p.C + c, any && !p.frozen);
}

#ifdef __CUDACC__
__global__ void rmsprop_row_kernel(RMSParams p) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.rows) rmsprop_row(p, r);
}

// one warp per row, lane c on channels c, c + 32, ...
__global__ void rmsprop_warp_kernel(RMSParams p) {
    const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (r >= p.rows) return;  // whole warps leave together
    bool nz = false;
    for (int c = lane; c < p.C; c += 32) nz = nz || p.grad[r * p.C + c] != 0.0f;
    const bool any = __any_sync(0xffffffffu, nz);
    for (int c = lane; c < p.C; c += 32) rmsprop_elem(p, r * p.C + c, any && !p.frozen);
}

extern "C" cudaError_t rmsprop(float* param, float* rms, const float* grad, long long rows, int C,
                               float lr, float beta, float one_m_beta, float eps, int has_clip,
                               float clip, int has_min, float minval, int frozen, void* stream) {
    if (rows <= 0) return cudaSuccess;
    const RMSParams p{param, rms, grad, rows, C, lr, beta, one_m_beta, eps, has_clip, clip,
                      has_min, minval, frozen};
    const int block = 256;
    if (C <= 4) {
        rmsprop_row_kernel<<<(unsigned)((rows + block - 1) / block), block, 0,
                             (cudaStream_t)stream>>>(p);
    } else {
        rmsprop_warp_kernel<<<(unsigned)((rows * 32 + block - 1) / block), block, 0,
                              (cudaStream_t)stream>>>(p);
    }
    return cudaGetLastError();
}
#endif
