// K9g iso points: the surface points of the extraction.
//
// Replaces the JAX package's geometry/extract.py:_extract_cell_points (46)
// and its caller extract_iso_points (94), svox2's cubic_extract_iso_pts
// (svox2_kernel.cu:248-382). For every occupied cell (flat link-lattice id,
// all 8 corner links present) and each axis, n^2 rays start on the cell's
// face at the lattice (i / (n - 1), j / (n - 1)) of the two other axes, in
// the order of JAX's ij meshgrid, and run along the unit axis. A ray takes
// the cubic of the trilinear field minus its level (samples.cuh's
// cubic_coeffs and cubic_roots: Vieta with two clamped Newton steps, roots
// under 1e4) and keeps the first root slot in [0, 1] whose trilinear
// density at the point, clipped to the unit cube, is >= density_thresh;
// it writes the point plus the cell's corner l, or NaN. Along an axis the
// trilinear field is linear and the solver takes its linear branch; it is
// kept as it is, so the points are JAX's.
//
// One thread per (cell, axis, ray): 3 n^2 threads a cell, each gathering
// the cell's 8 links and 16 values (neighbouring threads share them in L1).
// Bound: the links, rows and cell ids read once and the (cells, 3 n^2, 3)
// output written once, against about 200 float operations a ray; at n = 5
// the output dominates, so the kernel is bound by the bytes it writes.
#include <limits>

#include "samples.cuh"

HD float quiet_nan() {
#ifdef __CUDA_ARCH__
    return __int_as_float(0x7fc00000);
#else
    return std::numeric_limits<float>::quiet_NaN();
#endif
}

// the point of ray (axis, p1, p2) in a cell whose corners hold the field
// minus its level (s8) and the density (d8); false when it has none
HD bool iso_point(const float s8[8], const float d8[8], int axis, float p1, float p2,
                  float density_thresh, float pt[3]) {
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    d[axis] = 1.0f;
    o[axis == 0 ? 1 : 0] = p1;  // the two other axes, ascending
    o[axis == 2 ? 1 : 2] = p2;
    float f[4];
    cubic_coeffs(s8, o, d, f);
    float r[3];
    bool has[3];
    cubic_roots(f[0], f[1], f[2], f[3], r, has);  // slots without a root hold -1
    for (int j = 0; j < 3; ++j) {
        if (!(r[j] >= 0.0f && r[j] <= 1.0f)) continue;
        float pos[3], w[8];
        for (int a = 0; a < 3; ++a) pos[a] = o[a] + r[j] * d[a];
        trilerp_weights(fminf(fmaxf(pos[0], 0.0f), 1.0f), fminf(fmaxf(pos[1], 0.0f), 1.0f),
                        fminf(fmaxf(pos[2], 0.0f), 1.0f), w);
        if (corner_dot(w, d8) >= density_thresh) {
            for (int a = 0; a < 3; ++a) pt[a] = pos[a];
            return true;
        }
    }
    return false;
}

// thread t: cell t / (3 n^2), axis and ray from the rest; writes out[t]
HD void iso_points_at(int64_t t, const int64_t* cells, const int* links, int X, int Y, int Z,
                      const float* field, const float* dens, float lv, float density_thresh,
                      int n, float* out) {
    const int m = n * n;
    const int64_t cell = t / (3 * m);
    const int ray = (int)(t - cell * 3 * m);
    const int axis = ray / m, k = ray % m;
    const int64_t id = cells[cell];
    const int l[3] = {(int)(id / ((int64_t)Y * Z)), (int)((id / Z) % Y), (int)(id % Z)};
    float s8[8], d8[8];
    bool ok = true;
    for (int c = 0; c < 8; ++c) {
        const int cx = clampi(l[0] + corner_dx(c), 0, X - 1);
        const int cy = clampi(l[1] + corner_dy(c), 0, Y - 1);
        const int cz = clampi(l[2] + corner_dz(c), 0, Z - 1);
        const int link = links[((int64_t)cx * Y + cy) * Z + cz];
        const bool present = link >= 0;
        ok = ok && present;
        s8[c] = (present ? field[link] : 0.0f) - lv;
        d8[c] = present ? dens[link] : 0.0f;
    }
    const float den = (float)(n > 1 ? n - 1 : 1);
    float pt[3];
    const bool hit = ok && iso_point(s8, d8, axis, (float)(k / n) / den, (float)(k % n) / den,
                                     density_thresh, pt);
    for (int a = 0; a < 3; ++a) out[3 * t + a] = hit ? pt[a] + (float)l[a] : quiet_nan();
}

#ifdef __CUDACC__
__global__ void iso_points_kernel(int64_t n_threads, const int64_t* cells, const int* links, int X,
                                  int Y, int Z, const float* field, const float* dens, float lv,
                                  float density_thresh, int n, float* out) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_threads) return;
    iso_points_at(t, cells, links, X, Y, Z, field, dens, lv, density_thresh, n, out);
}

extern "C" cudaError_t iso_points(const int64_t* cells, int N, const int* links, int X, int Y,
                                  int Z, const float* field, const float* dens, float lv,
                                  float density_thresh, int n, float* out, void* stream) {
    const int64_t n_threads = (int64_t)N * 3 * n * n;
    if (n_threads <= 0) return cudaSuccess;
    const int block = 256;
    iso_points_kernel<<<(unsigned)((n_threads + block - 1) / block), block, 0,
                        (cudaStream_t)stream>>>(n_threads, cells, links, X, Y, Z, field, dens,
                                                lv, density_thresh, n, out);
    return cudaGetLastError();
}
#endif
