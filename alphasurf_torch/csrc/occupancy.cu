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
// K1d, density_occupancy_words, replaces render/cuvol.py:density_occupancy
// (30-62), the occupancy of the cuvol (density) renderer: a voxel is
// occupied when some present corner has density > 0, since a sample's
// sigma is the relu of a convex combination of the corners with absent
// ones reading 0. The same layout, bound and walk as K1, with its own
// vertex predicate; its words feed K2 unchanged.
//
// Bound: bytes. The kernel must read the (X, Y, Z) int32 links once
// (537 MB at 512^3) and write (X-1)(Y-1)ceil((Z-1)/32) words; the density
// rows it gathers are the capacity-sized table (UDF_ALPHA's one value),
// and the surface rows too under the hull test.
//
// Design: a walk over vertex rows, each link loaded about twice and from
// DRAM about once. A warp owns voxel column x, a window of 128 voxels along
// z (4 words) and a run of voxel rows along y, which it walks. Lane j holds
// vertices z0 + 4j .. z0 + 4j + 3 of the two vertex columns x and x + 1 and
// the window's last lane also the vertex after the window. The rows come
// through a ring of kOccStages rows a warp in shared memory, filled by
// cp.async (16-byte copies where Z % 4 == 0 and the links are 16-byte
// aligned, else 4-byte ones), kOccStages - 1 rows ahead of the row in use,
// so that a warp keeps ~3 KB of loads in flight without registers for them.
// Per vertex row the lane
//   1. reads, for each vertex present in both columns, its density and
//      surface value once (the types' strides and softplus included) and
//      combines the two columns in registers: present, max density,
//      min/max surface;
//   2. takes vertex z0 + 4j + 4 from the next lane (__shfl_down_sync) and
//      combines each z and z + 1: the 4 voxels' values of this row pair;
//   3. combines them with the previous row's, carried in registers, which
//      gives voxels (x, y - 1, z0 + 4j .. + 3): the level-set test is the
//      old one, `lv >= smin && lv <= smax` in the same order, and min/max
//      are exact in any order, so the bits are the plain version's;
//   4. packs its 4 bits into word j / 8 by shuffles (8 lanes x 4 bits), and
//      lanes 0, 8, 16, 24 store the window's 4 consecutive words.
// A row where no lane has a vertex present in both columns or a carried
// one (a vote) writes zero words and skips the rest. The second load of a
// link comes from L1 or L2 (a block holds kOccWarps consecutive columns);
// a run's first row is loaded once more by the run before it. Runs are 32
// rows, halved down to 4 while the launch would give an SM fewer than
// kOccWarpsPerSM warps (at 256^3 and below a run of 32 is one wave whose
// warps each wait out 33 rows of latency). Index math is 32-bit but for a
// warp's 64-bit column base. At most 64 registers (8 blocks of 4 warps an
// SM), no spills (nvcc -Xptxas -v).
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

constexpr int kOccVerts = 4;                 // z vertices a lane
constexpr int kOccWindow = 32 * kOccVerts;   // voxels of a warp's z window: 4 words
constexpr int kOccRows = 32;                 // voxel rows along y a warp walks
constexpr int kOccWarps = 4;                 // warps a block, on consecutive x columns

// One present vertex's density and surface value, read once for the 8
// voxels it is a corner of. kTypes: the strided rows, the softplus and the
// skipped hull of the other surface types; without it SDF's unit strides
// under the hull test.
template <bool kTypes>
HD void vertex_values(const OccParams& p, int link, float& d, float& s) {
    if (!kTypes) {
        d = p.density[link];
        s = p.surface[link];
        return;
    }
    d = p.density[(int64_t)link * p.dens_stride];
    s = 0.0f;
    if (!p.hull) return;  // the surface rows only feed the hull test
    const float raw = p.surface[(int64_t)link * p.n_surf_c];
    s = p.udf ? softplus_f(raw) : raw;
}

// K1's test of a voxel whose 8 corners are present, from their combined
// values: max density, min and max surface value
HD bool voxel_passes(const OccParams& p, float dmax, float smin, float smax) {
    if (!(dmax >= p.sigma_thresh)) return false;
    if (!p.hull) return true;
    for (int i = 0; i < p.n_lv; ++i) {
        const float lv = p.level_sets[i];
        if (lv >= smin && lv <= smax) return true;
    }
    return false;
}

// the voxels of a lane's 4 that lie below Z - 1, of n = Z - 1 - zl
HD int lane_voxels(int n) { return n < 0 ? 0 : (n > kOccVerts ? kOccVerts : n); }

// K1d's vertex value: its density, 0 where absent (a vertex counts where > 0)
HD float vertex_density(const float* density, int link) {
    return link >= 0 ? density[link] : 0.0f;
}

#ifdef __CUDACC__
// Asynchronous copies global -> shared (cp.async, through L1) of 4 or 16
// bytes, their groups and the wait for all but the newest N groups; a
// host build of the per-thread code copies at once.
__device__ __forceinline__ void copy_async(int* dst, const int* src, int bytes) {
#ifdef __CUDA_ARCH__
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes == 16)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
    for (int i = 0; i < bytes / 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The 4 bits of lanes 8i .. 8i + 7 ORed into word i of the window, on every
// lane of the group
__device__ __forceinline__ unsigned pack_nibbles(unsigned nib, int lane) {
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(kFullWarp, w, 1);
    w |= __shfl_xor_sync(kFullWarp, w, 2);
    w |= __shfl_xor_sync(kFullWarp, w, 4);
    return w;
}

// A warp's ring of kOccStages vertex rows in shared memory: of each of the
// two columns, the window's 128 vertices (lane j's 4 at 4j) and the extra
// one (at 128). A lane reads only what it copied itself.
constexpr int kOccStages = 4;
constexpr int kOccRowInts = kOccWindow + 4;  // 16-byte aligned rows
using OccRing = int[kOccStages][2][kOccRowInts];

// The walk, shared by K1 and K1d: the warp's window (its lane's first
// vertex zl and the extra vertex zx), its rows [y0, y1], the links of
// column x at the next row to copy and the pointer of its next word.
struct OccWalk {
    int lane, zl, zx, y0, y1, Z, W;
    int64_t YZ;
    bool last, writer;
    const int* src;
    unsigned* out;
    int* ring;  // this warp's OccRing

    // copies of the next vertex row of both columns into stage `st`
    template <bool kVec>
    __device__ __forceinline__ void issue(int st) {
        for (int c = 0; c < 2; ++c) {
            const int* r = c ? src + YZ : src;
            int* d = ring + (st * 2 + c) * kOccRowInts;
            if (kVec) {  // Z % 4 == 0 and zl % 4 == 0: zl < Z holds the 4 vertices
                if (zl < Z) copy_async(d + kOccVerts * lane, r + zl, 16);
            } else {
                for (int k = 0; k < kOccVerts; ++k)
                    if (zl + k < Z) copy_async(d + kOccVerts * lane + k, r + zl + k, 4);
            }
            if (last && zx < Z) copy_async(d + kOccWindow, r + zx, 4);
        }
        src += Z;
    }

    // -1 in the lane's slots past Z of every stage, which no copy writes
    __device__ __forceinline__ void clear_past_z() const {
        for (int sc = 0; sc < 2 * kOccStages; ++sc) {
            int* d = ring + sc * kOccRowInts;
            for (int k = 0; k < kOccVerts; ++k)
                if (zl + k >= Z) d[kOccVerts * lane + k] = -1;
            if (last && zx >= Z) d[kOccWindow] = -1;
        }
    }

    // the links of stage `st`: a of column x, b of column x + 1; the 5th
    // the last lane's extra vertex, -1 on the others
    template <bool kVec>
    __device__ __forceinline__ void read(int st, int a[5], int b[5]) const {
        const int* d0 = ring + st * 2 * kOccRowInts;
        const int* d1 = d0 + kOccRowInts;
        if (kVec) {
            const int4 qa = *reinterpret_cast<const int4*>(d0 + kOccVerts * lane);
            const int4 qb = *reinterpret_cast<const int4*>(d1 + kOccVerts * lane);
            a[0] = qa.x, a[1] = qa.y, a[2] = qa.z, a[3] = qa.w;
            b[0] = qb.x, b[1] = qb.y, b[2] = qb.z, b[3] = qb.w;
        } else {
            for (int k = 0; k < kOccVerts; ++k) {
                a[k] = d0[kOccVerts * lane + k];
                b[k] = d1[kOccVerts * lane + k];
            }
        }
        a[4] = last ? d0[kOccWindow] : -1;
        b[4] = last ? d1[kOccWindow] : -1;
    }

    // start the ring: rows y0 .. y0 + kOccStages - 2, a group each
    template <bool kVec>
    __device__ __forceinline__ void prologue() {
        clear_past_z();
        for (int i = 0; i < kOccStages - 1; ++i) {
            if (y0 + i <= y1) issue<kVec>(i);
            copy_commit();
        }
    }

    // step i of the walk, at row y: row y + kOccStages - 1 copied into the
    // stage row y - 1 held, then a wait until row y + kAhead has arrived
    // (in stage (i + kAhead) % kOccStages)
    template <bool kVec, int kAhead>
    __device__ __forceinline__ void advance(int y, int i) {
        if (y + kOccStages - 1 <= y1) issue<kVec>((i + kOccStages - 1) % kOccStages);
        copy_commit();
        copy_wait<kOccStages - 1 - kAhead>();
    }

    // the word of voxel row y - 1 (none at the run's first row)
    __device__ __forceinline__ void store(int y, unsigned word) {
        if (y == y0) return;
        if (writer) *out = word;
        out += W;
    }
};

__device__ __forceinline__ bool occ_walk(const int* links, int X, int Y, int Z, int W, int rows,
                                         unsigned* words, OccRing* rings, OccWalk& s) {
    s.lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int x = blockIdx.x * kOccWarps + warp;
    if (x >= X - 1) return false;  // warp-uniform
    const int z0 = blockIdx.y * kOccWindow;
    s.zl = z0 + kOccVerts * s.lane;
    s.zx = z0 + kOccWindow;
    s.Z = Z;
    s.W = W;
    s.YZ = (int64_t)Y * Z;
    s.last = s.lane == 31;
    s.y0 = blockIdx.z * rows;
    s.y1 = min(s.y0 + rows, Y - 1);
    const int w = blockIdx.y * (kOccWindow / 32) + (s.lane >> 3);
    s.writer = (s.lane & 7) == 0 && w < W;
    s.src = links + (int64_t)x * s.YZ + (int64_t)s.y0 * Z;
    s.out = words + ((int64_t)x * (Y - 1) + s.y0) * W + w;
    s.ring = &rings[warp][0][0][0];
    return true;
}

template <bool kTypes, bool kVec>
__global__ void __launch_bounds__(32 * kOccWarps, 8)
    occupancy_kernel(OccParams p, int W, int rows, unsigned* words) {
    __shared__ __align__(16) OccRing rings[kOccWarps];
    OccWalk s;
    if (!occ_walk(p.links, p.X, p.Y, p.Z, W, rows, words, rings, s)) return;
    s.prologue<kVec>();
    // the previous row pair's z-combined values: present bits, max density,
    // min and max surface of voxels zl .. zl + 3
    unsigned cp = 0u;
    float cd[4], clo[4], chi[4];
    for (int y = s.y0, i = 0; y <= s.y1; ++y, ++i) {
        int a[5], b[5];
        s.advance<kVec, 0>(y, i);
        s.read<kVec>(i % kOccStages, a, b);
        unsigned pv = 0u;  // vertex k present in both columns
        for (int k = 0; k < 5; ++k) pv |= (unsigned)((a[k] | b[k]) >= 0) << k;
        if (!__any_sync(kFullWarp, (pv | cp) != 0u)) {  // nothing present here or carried
            s.store(y, 0u);
            continue;
        }
        unsigned pz = 0u;  // voxel k's 4 corners of this row present
        float dz[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        float loz[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
        float hiz[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        if (__any_sync(kFullWarp, pv != 0u)) {
            float d[5], lo[5], hi[5];
            for (int k = 0; k < 5; ++k) {
                d[k] = -INFINITY;
                lo[k] = INFINITY;
                hi[k] = -INFINITY;
                if (pv >> k & 1u) {
                    float da, sa, db, sb;
                    vertex_values<kTypes>(p, a[k], da, sa);
                    vertex_values<kTypes>(p, b[k], db, sb);
                    d[k] = fmaxf(da, db);
                    lo[k] = fminf(sa, sb);
                    hi[k] = fmaxf(sa, sb);
                }
            }
            // vertex 4 is the next lane's vertex 0; the last lane's own extra
            const unsigned p0 = __ballot_sync(kFullWarp, pv & 1u);
            const float d4 = __shfl_down_sync(kFullWarp, d[0], 1);
            const float lo4 = __shfl_down_sync(kFullWarp, lo[0], 1);
            const float hi4 = __shfl_down_sync(kFullWarp, hi[0], 1);
            if (!s.last) {
                pv = (pv & 15u) | ((p0 >> (s.lane + 1)) & 1u) << 4;
                d[4] = d4;
                lo[4] = lo4;
                hi[4] = hi4;
            }
            pz = pv & (pv >> 1) & 15u;
            for (int k = 0; k < 4; ++k) {
                dz[k] = fmaxf(d[k], d[k + 1]);
                loz[k] = fminf(lo[k], lo[k + 1]);
                hiz[k] = fmaxf(hi[k], hi[k + 1]);
            }
        }
        // voxel row y - 1: the carried row and this one
        const unsigned both = cp & pz;
        unsigned word = 0u;
        if (y > s.y0 && __any_sync(kFullWarp, both != 0u)) {
            unsigned nib = 0u;
            for (int k = 0; k < 4; ++k)
                if ((both >> k & 1u) &&
                    voxel_passes(p, fmaxf(cd[k], dz[k]), fminf(clo[k], loz[k]),
                                 fmaxf(chi[k], hiz[k])))
                    nib |= 1u << k;
            word = pack_nibbles(nib, s.lane);
        }
        s.store(y, word);
        cp = pz;
        for (int k = 0; k < 4; ++k) {
            cd[k] = dz[k];
            clo[k] = loz[k];
            chi[k] = hiz[k];
        }
    }
}

// K1d's densities of a row's vertices: columns x (0-4) and x + 1 (5-9),
// 0 where absent; loads issued here, consumed a step later
template <bool kVec>
__device__ __forceinline__ void row_densities(const OccWalk& s, const float* density, int st,
                                              float d[10]) {
    int a[5], b[5];
    s.read<kVec>(st, a, b);
    for (int k = 0; k < 5; ++k) {
        d[k] = vertex_density(density, a[k]);
        d[5 + k] = vertex_density(density, b[k]);
    }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kOccWarps, 8)
    density_occupancy_kernel(const int* links, const float* density, int X, int Y, int Z, int W,
                             int rows, unsigned* words) {
    __shared__ __align__(16) OccRing rings[kOccWarps];
    OccWalk s;
    if (!occ_walk(links, X, Y, Z, W, rows, words, rings, s)) return;
    s.prologue<kVec>();
    // the lane's voxels below Z - 1 (an OR, unlike K1's AND, does not clear
    // a voxel whose upper corner lies past the lattice)
    const unsigned inside = (1u << lane_voxels(Z - 1 - s.zl)) - 1u;
    // the densities of row y, gathered while row y - 1 was combined
    float d[10];
    copy_wait<kOccStages - 2>();
    row_densities<kVec>(s, density, 0, d);
    unsigned cq = 0u;  // the previous row pair's z-combined bits
    for (int y = s.y0, i = 0; y <= s.y1; ++y, ++i) {
        s.advance<kVec, 1>(y, i);
        float nd[10];
        if (y < s.y1) row_densities<kVec>(s, density, (i + 1) % kOccStages, nd);
        unsigned q = 0u;  // vertex k dense in either column
        for (int k = 0; k < 5; ++k) q |= (unsigned)(d[k] > 0.0f || d[5 + k] > 0.0f) << k;
        const unsigned q0 = __ballot_sync(kFullWarp, q & 1u);
        if (!s.last) q = (q & 15u) | ((q0 >> (s.lane + 1)) & 1u) << 4;
        const unsigned qz = (q | q >> 1) & inside;
        const unsigned nib = cq | qz;
        s.store(y, __any_sync(kFullWarp, nib != 0u) ? pack_nibbles(nib, s.lane) : 0u);
        cq = qz;
        if (y < s.y1)
            for (int k = 0; k < 10; ++k) d[k] = nd[k];
    }
}

// 16-byte copies of 4 vertices: rows of a multiple of 4 links, 16-byte aligned
static bool occ_vec(const int* links, int Z) {
    return Z % 4 == 0 && reinterpret_cast<uintptr_t>(links) % 16 == 0;
}

// The walk's grid: x tiles, z windows, y runs of `rows` voxel rows, the
// longest run (of kOccRows, halved down to 4) that still gives every SM
// kOccWarpsPerSM warps; shorter runs load their first row once more.
constexpr int kOccWarpsPerSM = 64;

static dim3 occ_grid(int X, int Y, int Z, int& rows) {
    static int n_sm = 0;
    if (n_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n_sm = 132;
    }
    const int64_t cols = (int64_t)(X - 1) * ((Z - 1 + kOccWindow - 1) / kOccWindow);
    rows = kOccRows;
    while (rows > 4 && cols * ((Y - 1 + rows - 1) / rows) < (int64_t)n_sm * kOccWarpsPerSM)
        rows /= 2;
    return dim3((unsigned)((X - 1 + kOccWarps - 1) / kOccWarps),
                (unsigned)((Z - 1 + kOccWindow - 1) / kOccWindow),
                (unsigned)((Y - 1 + rows - 1) / rows));
}

extern "C" cudaError_t occupancy_words(const int* links, const float* density, int dens_stride,
                                       const float* surface, int n_surf_c,
                                       const float* level_sets, int n_lv, int X, int Y, int Z,
                                       float sigma_thresh, int hull, int udf, int* words,
                                       void* stream) {
    const OccParams p{links, density, dens_stride, surface, n_surf_c, level_sets,
                      n_lv, X, Y, Z, sigma_thresh, hull, udf};
    const int W = (Z - 1 + 31) / 32;
    if (X < 2 || Y < 2 || Z < 2) return cudaSuccess;
    int rows = 0;
    const dim3 grid = occ_grid(X, Y, Z, rows);
    const dim3 block(32 * kOccWarps);
    cudaStream_t st = (cudaStream_t)stream;
    unsigned* out = reinterpret_cast<unsigned*>(words);
    const bool sdf = dens_stride == 1 && n_surf_c == 1 && !udf && hull;
    if (occ_vec(links, Z)) {
        if (sdf) occupancy_kernel<false, true><<<grid, block, 0, st>>>(p, W, rows, out);
        else occupancy_kernel<true, true><<<grid, block, 0, st>>>(p, W, rows, out);
    } else {
        if (sdf) occupancy_kernel<false, false><<<grid, block, 0, st>>>(p, W, rows, out);
        else occupancy_kernel<true, false><<<grid, block, 0, st>>>(p, W, rows, out);
    }
    return cudaGetLastError();
}

extern "C" cudaError_t density_occupancy_words(const int* links, const float* density, int X,
                                               int Y, int Z, int* words, void* stream) {
    const int W = (Z - 1 + 31) / 32;
    if (X < 2 || Y < 2 || Z < 2) return cudaSuccess;
    int rows = 0;
    const dim3 grid = occ_grid(X, Y, Z, rows);
    const dim3 block(32 * kOccWarps);
    cudaStream_t st = (cudaStream_t)stream;
    unsigned* out = reinterpret_cast<unsigned*>(words);
    if (occ_vec(links, Z))
        density_occupancy_kernel<true><<<grid, block, 0, st>>>(links, density, X, Y, Z, W, rows, out);
    else
        density_occupancy_kernel<false><<<grid, block, 0, st>>>(links, density, X, Y, Z, W, rows, out);
    return cudaGetLastError();
}
#endif
