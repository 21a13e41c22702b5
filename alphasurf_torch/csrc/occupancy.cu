// K1: voxel occupancy, bit-packed along z.
//
// Replaces the JAX package's render/surface.py:voxel_occupancy (1149-1234) and
// pack_occupancy_bits (1326-1338). A voxel is occupied when all 8 corner
// links are present, the largest corner raw alpha is >= sigma_thresh and,
// with the hull test on, a level set lies within the corners' surface
// min/max. The surface types' branches: the UDF types test the softplus of
// their corner values (udf); UDF_ALPHA has one alpha per level set, so the
// caller passes the table's largest as a single value that every corner
// reads (dens_stride 0); PLANE and VOXEL_FACE skip the hull (hull 0), as
// do unrestricted fake samples. The surface rows are n_surf_c wide
// (PLANE's 4), channel 0 is read, and only under the hull test.
//
// Bound: bytes. The kernel must read the (X, Y, Z) int32 links once
// (537 MB at 512^3) and write (X-1)(Y-1)ceil((Z-1)/32) words; the density
// rows it gathers are the capacity-sized table (UDF_ALPHA's one value),
// and the surface rows too under the hull test. Design: one
// thread per voxel, one warp per 32 consecutive z-voxels, so each corner
// load is one coalesced 128-byte line and __ballot_sync forms the packed
// word in registers. The JAX version first scatters two dense (X, Y, Z)
// float fields of density and surface; this kernel gathers the rows
// through the links instead and never builds them.
//
// K1d, density_occupancy_words, replaces render/cuvol.py:density_occupancy
// (30-62), the occupancy of the cuvol (density) renderer: a voxel is
// occupied when some present corner has density > 0, since a sample's
// sigma is the relu of a convex combination of the corners with absent
// ones reading 0. The same layout, bound and design as K1, without the
// surface rows and the hull test; its words feed K2 unchanged.
#include "common.cuh"

struct OccParams {
    const int* links;
    const float* density;  // (cap,), or (1,) read by every corner (dens_stride 0)
    int dens_stride;
    const float* surface;  // (cap, n_surf_c), channel 0
    int n_surf_c;
    const float* level_sets;
    int n_lv;
    int X, Y, Z;
    float sigma_thresh;
    int hull, udf;
};

// kTypes: the strided rows, the softplus and the skipped hull of the other
// surface types; without it SDF's unit strides under the hull test, in the
// 32 registers that keep a full SM of warps (the general path takes 37)
template <bool kTypes>
HD bool voxel_occupied(const OccParams& p, int x, int y, int z) {
    float dmax = -INFINITY, smin = INFINITY, smax = -INFINITY;
    for (int c = 0; c < 8; ++c) {
        const int64_t idx =
            ((int64_t)(x + corner_dx(c)) * p.Y + (y + corner_dy(c))) * p.Z + (z + corner_dz(c));
        const int link = p.links[idx];
        if (link < 0) return false;
        if (!kTypes) {
            dmax = fmaxf(dmax, p.density[link]);
            const float s = p.surface[link];
            smin = fminf(smin, s);
            smax = fmaxf(smax, s);
            continue;
        }
        dmax = fmaxf(dmax, p.density[(int64_t)link * p.dens_stride]);
        if (!p.hull) continue;  // the surface rows only feed the hull test
        const float raw = p.surface[(int64_t)link * p.n_surf_c];
        const float s = p.udf ? softplus_f(raw) : raw;
        smin = fminf(smin, s);
        smax = fmaxf(smax, s);
    }
    if (!(dmax >= p.sigma_thresh)) return false;
    if (!p.hull) return true;
    for (int i = 0; i < p.n_lv; ++i) {
        const float lv = p.level_sets[i];
        if (lv >= smin && lv <= smax) return true;
    }
    return false;
}

HD bool density_voxel_occupied(const int* links, const float* density, int Y, int Z, int x, int y,
                               int z) {
    for (int c = 0; c < 8; ++c) {
        const int64_t idx =
            ((int64_t)(x + corner_dx(c)) * Y + (y + corner_dy(c))) * Z + (z + corner_dz(c));
        const int link = links[idx];
        if (link >= 0 && density[link] > 0.0f) return true;
    }
    return false;
}

#ifdef __CUDACC__
template <bool kTypes>
__global__ void occupancy_kernel(OccParams p, int W, int64_t n_words, unsigned* words) {
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n_words) return;  // warp-uniform: blockDim is a multiple of 32
    const int w = (int)(warp % W);
    const int64_t xy = warp / W;
    const int y = (int)(xy % (p.Y - 1));
    const int x = (int)(xy / (p.Y - 1));
    const int z = w * 32 + lane;
    const bool occ = z < p.Z - 1 && voxel_occupied<kTypes>(p, x, y, z);
    const unsigned bits = __ballot_sync(0xffffffffu, occ);
    if (lane == 0) words[warp] = bits;
}

extern "C" cudaError_t occupancy_words(const int* links, const float* density, int dens_stride,
                                       const float* surface, int n_surf_c,
                                       const float* level_sets, int n_lv, int X, int Y, int Z,
                                       float sigma_thresh, int hull, int udf, int* words,
                                       void* stream) {
    const OccParams p{links, density, dens_stride, surface, n_surf_c, level_sets,
                      n_lv, X, Y, Z, sigma_thresh, hull, udf};
    const int W = (Z - 1 + 31) / 32;
    const int64_t n_words = (int64_t)(X - 1) * (Y - 1) * W;
    if (n_words <= 0) return cudaSuccess;
    const int block = 256;
    const int64_t grid = (n_words * 32 + block - 1) / block;
    unsigned* out = reinterpret_cast<unsigned*>(words);
    const unsigned nb = (unsigned)grid;
    if (dens_stride == 1 && n_surf_c == 1 && !udf && hull)
        occupancy_kernel<false><<<nb, block, 0, (cudaStream_t)stream>>>(p, W, n_words, out);
    else
        occupancy_kernel<true><<<nb, block, 0, (cudaStream_t)stream>>>(p, W, n_words, out);
    return cudaGetLastError();
}

__global__ void density_occupancy_kernel(const int* links, const float* density, int X, int Y,
                                         int Z, int W, int64_t n_words, unsigned* words) {
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n_words) return;  // warp-uniform: blockDim is a multiple of 32
    const int w = (int)(warp % W);
    const int64_t xy = warp / W;
    const int y = (int)(xy % (Y - 1));
    const int x = (int)(xy / (Y - 1));
    const int z = w * 32 + lane;
    const bool occ = z < Z - 1 && density_voxel_occupied(links, density, Y, Z, x, y, z);
    const unsigned bits = __ballot_sync(0xffffffffu, occ);
    if (lane == 0) words[warp] = bits;
}

extern "C" cudaError_t density_occupancy_words(const int* links, const float* density, int X,
                                               int Y, int Z, int* words, void* stream) {
    const int W = (Z - 1 + 31) / 32;
    const int64_t n_words = (int64_t)(X - 1) * (Y - 1) * W;
    if (n_words <= 0) return cudaSuccess;
    const int block = 256;
    const int64_t grid = (n_words * 32 + block - 1) / block;
    density_occupancy_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        links, density, X, Y, Z, W, n_words, reinterpret_cast<unsigned*>(words));
    return cudaGetLastError();
}
#endif
