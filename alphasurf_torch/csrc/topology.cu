// K9a keep masks and K9b trilinear resample of the stage transitions.
//
// K9a replaces the JAX package's core/topology_device.py:_mask_pass_j (110),
// _prune_mask_j (223) and _lv_band_mask_j (122); K9b replaces
// _resize_channel_j (104) and _gather_channels_j (167) with the
// interpolation tables of _interp_matrix (48) and the emptiness test of
// _cell_matrix (66). svox2 did this work in misc_kernel.cu (dilate) and
// sample_grid_raw_alpha.
//
// K9a. A keep mask on a dense (X, Y, Z) lattice: a threshold (crit >= t),
// or the prune rule (present density > t, optionally with a surface sign
// change among the 27 neighbours, zero outside the lattice), then a
// (2n+1)^3 Chebyshev dilation; and the level-set band, the 8 corners of
// every voxel whose corner hull [smin, smax] holds a level set. Both are
// box maxima, so each is three 1-D passes of window_or_kernel, one per
// axis, over uint8 masks: out[i] = OR of in[i + a .. i + b] within the
// input. The dilation is a = -n, b = n on the lattice; the band is a = -1,
// b = 0 from the (X-1, Y-1, Z-1) voxels to the vertices, which is the JAX
// reduce_window with a 2^3 window and padding (1, 1). The first pass reads
// the float criterion and thresholds it, so no float mask is written.
// Bound: bytes. Each pass reads and writes one byte a vertex (the first
// reads the 4-byte criterion); 537 MB of float32 at 512^3. One thread per
// output vertex, neighbouring threads on neighbouring z, so the window's
// loads of a warp fall in a few lines that the L1 holds.
//
// K9b. Each new vertex (i, j, k) lies in old cell (l_x[i], l_y[j], l_z[k])
// at weights (f, 1 - f) per axis, from per-axis tables computed on the
// host in float64 and rounded to float32 as _interp_matrix does (positions
// recomputed on the card in float32 would differ in the last bit and flip
// thresholds). A corner whose link is empty reads the channel's fill. The
// value is the JAX separable resample: the lerp along x at each of the 4
// (y, z) corner columns, then along y, then along z; each of JAX's 1-D
// matrices has two non-zero entries per row, so the 8 corner reads give its
// values without the 29 dense old channels it builds. Two modes: every new
// vertex of one channel (dense_kernel, one thread per vertex), and all
// channels of the kept vertices (rows_kernel, one warp per vertex, lane =
// channel, so each corner row is one coalesced read); rows_kernel also
// returns whether a corner of the cell was empty, the non_expanding test
// of _cell_matrix. Bound: bytes. The dense mode writes 4 bytes a new vertex
// and reads the links and one channel of the old grid; the rows mode
// writes N rows and reads the corner rows it needs.
#include "common.cuh"

struct Tables {
    const int* l[3];
    const float* f[3];  // weight of corner l + 1
    const float* g[3];  // weight of corner l: 1 - f, rounded in float32
};

HD float lerp_gf(float g, float f, float a, float b) { return g * a + f * b; }

// the separable trilerp of one channel from its 8 corner values (z fastest)
HD float trilerp_sep(const float v[8], float gx, float fx, float gy, float fy, float gz, float fz) {
    float a[4];
    for (int c = 0; c < 4; ++c) a[c] = lerp_gf(gx, fx, v[c], v[4 + c]);  // (y, z) = c
    const float b0 = lerp_gf(gy, fy, a[0], a[2]);  // z = 0
    const float b1 = lerp_gf(gy, fy, a[1], a[3]);  // z = 1
    return lerp_gf(gz, fz, b0, b1);
}

HD void corner_links(const int* links, int Y, int Z, int lx, int ly, int lz, int lk[8]) {
    for (int c = 0; c < 8; ++c)
        lk[c] = links[((int64_t)(lx + corner_dx(c)) * Y + (ly + corner_dy(c))) * Z + lz + corner_dz(c)];
}

HD bool voxel_straddles(const float* surf, int Y, int Z, int x, int y, int z, const float* lvs,
                        int n_lv) {
    float smin = INFINITY, smax = -INFINITY;
    for (int c = 0; c < 8; ++c) {
        const float s = surf[((int64_t)(x + corner_dx(c)) * Y + (y + corner_dy(c))) * Z + z +
                             corner_dz(c)];
        smin = fminf(smin, s);
        smax = fmaxf(smax, s);
    }
    for (int i = 0; i < n_lv; ++i)
        if (lvs[i] >= smin && lvs[i] <= smax) return true;
    return false;
}

HD float signf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

HD bool prune_valid(const int* links, const float* dens, const float* surf, float thresh, int X,
                    int Y, int Z, int x, int y, int z) {
    const int lk = links[((int64_t)x * Y + y) * Z + z];
    const float d = lk >= 0 ? dens[lk] : 0.0f;
    if (!(d > thresh)) return false;
    if (surf == nullptr) return true;
    const float s = lk >= 0 ? surf[lk] : 0.0f;
    if (s == 0.0f) return true;
    for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
            for (int dz = -1; dz <= 1; ++dz) {
                const int a = x + dx, b = y + dy, c = z + dz;
                float nb = 0.0f;
                if (a >= 0 && a < X && b >= 0 && b < Y && c >= 0 && c < Z) {
                    const int ln = links[((int64_t)a * Y + b) * Z + c];
                    nb = ln >= 0 ? surf[ln] : 0.0f;
                }
                if (nb == 0.0f || signf(s) != signf(nb)) return true;
            }
    return false;
}

// out[idx] (dims D0, D1, D2) = OR over in[j], j in [i + a, i + b] and
// [0, n_in), along axis (the input's dims are D with n_in on axis); the
// input is crit >= thresh when crit is given
HD void window_or_at(int64_t idx, const float* crit, float thresh, const uint8_t* in, int n_in,
                     int axis, int a, int b, int D0, int D1, int D2, uint8_t* out) {
    const int k = (int)(idx % D2);
    const int64_t ij = idx / D2;
    const int j = (int)(ij % D1);
    const int i = (int)(ij / D1);
    int pos[3] = {i, j, k};
    int dims[3] = {D0, D1, D2};
    dims[axis] = n_in;
    const int p0 = pos[axis];
    const int q0 = p0 + a > 0 ? p0 + a : 0;
    const int q1 = p0 + b < n_in - 1 ? p0 + b : n_in - 1;
    bool any = false;
    for (int q = q0; q <= q1 && !any; ++q) {
        pos[axis] = q;
        const int64_t src = ((int64_t)pos[0] * dims[1] + pos[1]) * dims[2] + pos[2];
        any = crit != nullptr ? crit[src] >= thresh : in[src] != 0;
    }
    out[idx] = any ? 1 : 0;
}

HD void prune_valid_at(int64_t idx, const int* links, const float* dens, const float* surf,
                       float thresh, int X, int Y, int Z, uint8_t* out) {
    const int z = (int)(idx % Z);
    const int y = (int)((idx / Z) % Y);
    const int x = (int)(idx / ((int64_t)Y * Z));
    out[idx] = prune_valid(links, dens, surf, thresh, X, Y, Z, x, y, z) ? 1 : 0;
}

HD void straddle_at(int64_t idx, const float* surf, int X, int Y, int Z, const float* lvs,
                    int n_lv, uint8_t* out) {
    const int Zv = Z - 1, Yv = Y - 1;
    const int z = (int)(idx % Zv);
    const int y = (int)((idx / Zv) % Yv);
    const int x = (int)(idx / ((int64_t)Yv * Zv));
    out[idx] = voxel_straddles(surf, Y, Z, x, y, z, lvs, n_lv) ? 1 : 0;
}

HD void resample_dense_at(int64_t idx, const int* links, int Y, int Z, const float* col,
                          float fill, const Tables& t, int Yn, int Zn, float* out) {
    const int k = (int)(idx % Zn);
    const int j = (int)((idx / Zn) % Yn);
    const int i = (int)(idx / ((int64_t)Yn * Zn));
    int lk[8];
    corner_links(links, Y, Z, t.l[0][i], t.l[1][j], t.l[2][k], lk);
    float v[8];
    for (int c = 0; c < 8; ++c) v[c] = lk[c] >= 0 ? col[lk[c]] : fill;
    out[idx] = trilerp_sep(v, t.g[0][i], t.f[0][i], t.g[1][j], t.f[1][j], t.g[2][k], t.f[2][k]);
}

// kept vertex w, channels lane, lane + 32, ...; lane 0 writes the flag
HD void resample_rows_at(int64_t w, int lane, const int* links, int Y, int Z, const float* rows,
                         int C, const float* fills, const int64_t* kept, const Tables& t, int Yn,
                         int Zn, float* out, uint8_t* touched) {
    const int64_t id = kept[w];
    const int k = (int)(id % Zn);
    const int j = (int)((id / Zn) % Yn);
    const int i = (int)(id / ((int64_t)Yn * Zn));
    int lk[8];
    corner_links(links, Y, Z, t.l[0][i], t.l[1][j], t.l[2][k], lk);
    const float gx = t.g[0][i], fx = t.f[0][i], gy = t.g[1][j], fy = t.f[1][j];
    const float gz = t.g[2][k], fz = t.f[2][k];
    for (int c = lane; c < C; c += 32) {
        float v[8];
        for (int q = 0; q < 8; ++q) v[q] = lk[q] >= 0 ? rows[(int64_t)lk[q] * C + c] : fills[c];
        out[w * C + c] = trilerp_sep(v, gx, fx, gy, fy, gz, fz);
    }
    if (lane == 0 && touched != nullptr) {
        bool empty = false;
        for (int q = 0; q < 8; ++q) empty = empty || lk[q] < 0;
        touched[w] = empty ? 1 : 0;
    }
}

#ifdef __CUDACC__
__device__ __forceinline__ int64_t thread_id() {
    return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void window_or_kernel(const float* crit, float thresh, const uint8_t* in, int n_in,
                                 int axis, int a, int b, int D0, int D1, int D2, uint8_t* out) {
    const int64_t idx = thread_id();
    if (idx < (int64_t)D0 * D1 * D2)
        window_or_at(idx, crit, thresh, in, n_in, axis, a, b, D0, D1, D2, out);
}

__global__ void prune_valid_kernel(const int* links, const float* dens, const float* surf,
                                   float thresh, int X, int Y, int Z, uint8_t* out) {
    const int64_t idx = thread_id();
    if (idx < (int64_t)X * Y * Z) prune_valid_at(idx, links, dens, surf, thresh, X, Y, Z, out);
}

__global__ void straddle_kernel(const float* surf, int X, int Y, int Z, const float* lvs, int n_lv,
                                uint8_t* out) {
    const int64_t idx = thread_id();
    if (idx < (int64_t)(X - 1) * (Y - 1) * (Z - 1)) straddle_at(idx, surf, X, Y, Z, lvs, n_lv, out);
}

__global__ void resample_dense_kernel(const int* links, int Y, int Z, const float* col, float fill,
                                      Tables t, int Xn, int Yn, int Zn, float* out) {
    const int64_t idx = thread_id();
    if (idx < (int64_t)Xn * Yn * Zn) resample_dense_at(idx, links, Y, Z, col, fill, t, Yn, Zn, out);
}

__global__ void resample_rows_kernel(const int* links, int Y, int Z, const float* rows, int C,
                                     const float* fills, const int64_t* kept, int64_t N, Tables t,
                                     int Yn, int Zn, float* out, uint8_t* touched) {
    const int64_t w = thread_id() >> 5;
    if (w < N)
        resample_rows_at(w, threadIdx.x & 31, links, Y, Z, rows, C, fills, kept, t, Yn, Zn, out,
                         touched);
}

static unsigned blocks(int64_t n, int block) { return (unsigned)((n + block - 1) / block); }

static Tables make_tables(const int* lx, const float* fx, const float* gx, const int* ly,
                          const float* fy, const float* gy, const int* lz, const float* fz,
                          const float* gz) {
    return Tables{{lx, ly, lz}, {fx, fy, fz}, {gx, gy, gz}};
}

extern "C" cudaError_t topo_window_or(const float* crit, float thresh, const uint8_t* in, int n_in,
                                      int axis, int a, int b, int D0, int D1, int D2, uint8_t* out,
                                      void* stream) {
    const int64_t n = (int64_t)D0 * D1 * D2;
    if (n <= 0) return cudaSuccess;
    window_or_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(crit, thresh, in, n_in, axis,
                                                                       a, b, D0, D1, D2, out);
    return cudaGetLastError();
}

extern "C" cudaError_t topo_prune_valid(const int* links, const float* dens, const float* surf,
                                        float thresh, int X, int Y, int Z, uint8_t* out,
                                        void* stream) {
    const int64_t n = (int64_t)X * Y * Z;
    if (n <= 0) return cudaSuccess;
    prune_valid_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(links, dens, surf, thresh,
                                                                         X, Y, Z, out);
    return cudaGetLastError();
}

extern "C" cudaError_t topo_straddle(const float* surf, int X, int Y, int Z, const float* lvs,
                                     int n_lv, uint8_t* out, void* stream) {
    const int64_t n = (int64_t)(X - 1) * (Y - 1) * (Z - 1);
    if (n <= 0) return cudaSuccess;
    straddle_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(surf, X, Y, Z, lvs, n_lv,
                                                                      out);
    return cudaGetLastError();
}

extern "C" cudaError_t topo_resample_dense(const int* links, int Y, int Z, const float* col,
                                           float fill, const int* lx, const float* fx,
                                           const float* gx, const int* ly, const float* fy,
                                           const float* gy, const int* lz, const float* fz,
                                           const float* gz, int Xn, int Yn, int Zn, float* out,
                                           void* stream) {
    const int64_t n = (int64_t)Xn * Yn * Zn;
    if (n <= 0) return cudaSuccess;
    resample_dense_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        links, Y, Z, col, fill, make_tables(lx, fx, gx, ly, fy, gy, lz, fz, gz), Xn, Yn, Zn, out);
    return cudaGetLastError();
}

extern "C" cudaError_t topo_resample_rows(const int* links, int Y, int Z, const float* rows, int C,
                                          const float* fills, const int64_t* kept, long long N,
                                          const int* lx, const float* fx, const float* gx,
                                          const int* ly, const float* fy, const float* gy,
                                          const int* lz, const float* fz, const float* gz, int Yn,
                                          int Zn, float* out, uint8_t* touched, void* stream) {
    if (N <= 0) return cudaSuccess;
    resample_rows_kernel<<<blocks(N * 32, 256), 256, 0, (cudaStream_t)stream>>>(
        links, Y, Z, rows, C, fills, kept, N, make_tables(lx, fx, gx, ly, fy, gy, lz, fz, gz), Yn,
        Zn, out, touched);
    return cudaGetLastError();
}
#endif
