// K2: phase A, the exact pool of occupied (ray, voxel) crossings.
//
// Replaces the JAX package's render/surface.py:compact_crossings_packed
// (1652-1734) with _packed_phase_a_coarse (1461-1625), _cross_coord and
// _entry_candidate (1404-1458), _pool_compact (1350-1398) and
// _finish_packed_pool (1628-1649). Candidates are the tnear entry and every
// interior axis plane crossed in (tnear + 1e-9, tmax - 1e-9); each names the
// voxel it enters in closed form; occupied ones whose voxel slab is not a
// degenerate sliver (far_t > close_t + 1e-9) are pool entries.
//
// Design: a per-ray count kernel, an exclusive scan of the counts outside
// any kernel, and a per-ray fill kernel that walks the same candidates and
// writes its entries at its offset. The pool is sized exactly (no budget,
// no overflow) and needs no sort: the walk merges the three axis-plane
// sequences, each monotone in t, after the entry candidate, so entries come
// out ray-major and t-ascending (equal t: lower axis first, the order a
// stable sort of the plain version's candidate list gives).
//
// Bound: operations. Per ray the walk does ~30 float operations for each
// plane crossed (about 3 * 512 at 512^3) and one lookup in the 16 MB
// occupancy words, which stay in the 50 MB L2; bytes moved are the rays in
// and the pool out. One thread per ray; the supervoxel prefilter of the
// JAX version is left out (it changes no voxel of the set).
//
// K11b, compact_fill: the first K entries of each ray, the JAX package's
// compact_crossings (render/surface.py:1284) over all_crossings (1237). The
// count pass is K2's (its n_valid is JAX's uncapped n_occupied); the scan
// runs over min(n_valid, K), and the fill walks as K2's and stops at the
// ray's end offset. Bound and design as K2's; the walk ends after K entries.
//
// K11a, dense_walk_count / dense_walk_fill: the occupied voxels of the JAX
// package's dense DDA walk (render/surface.py:1092 volume_render_surface,
// with ops/dda.py:85 next_crossing, :113 voxel_between, :125
// voxel_plane_ts). One thread walks one ray through JAX's float32 steps in
// JAX's order: pos = o + t d per axis, floor/ceil with the on-plane band
// 2e-6 (1 + |pos|), the least positive step over the axes, the midpoint
// voxel, t < tmax - 1e-9 to take a step and next_t < tmax + 1e-6 to go on,
// at most max_voxels steps. An in-bounds voxel whose K1 bit is set becomes
// an entry (ray, l, the slab's close_t and far_t), in walk order; a stalled
// walk may list a voxel twice, as JAX's walk composites it twice. The fill
// optionally writes each entry's walk step (steps, for return_samples'
// layout; null: not written). Count,
// exclusive scan and fill, as K2. Bound: operations, ~40 float operations a
// step for up to 3 (reso - 1) + 2 steps a ray; the pool is a few entries a
// ray. K3 and K4 then run on the pool unchanged.
//
// Exactness: _cross_coord compares a plane's crossing time t_q with the
// candidate's t, both computed as (p - o) / d, and o + t * d must round as
// in the plain version. Built with --fmad=false, so nothing is contracted
// into an FMA; rintf rounds half to even like torch.round.
#include "common.cuh"

struct PhaseAParams {
    const float* origins;
    const float* dirs;
    const float* tnear;
    const float* tmax;
    const unsigned* words;
    int reso[3];
    int W;
};

struct PoolOut {
    int* ray_id;
    int* l;
    float* close_t;
    float* far_t;
};

// the voxel coordinate of pb, snapped by crossing time within 1e-5 of a plane
HD int snap_coord(float o, float d, float pb, bool crossed_if_le, float t_ref, bool tie) {
    const float fl = floorf(pb);
    const float q = rintf(pb);
    if (!(fabsf(pb - q) < 1e-5f && d != 0.0f)) return (int)fl;
    const float tq = (q - o) / safe_dir(d);
    const bool crossed = crossed_if_le ? (tq <= t_ref) : (tq < t_ref || (tie && tq == t_ref));
    const float cr = crossed ? 1.0f : 0.0f;
    return (int)(d > 0.0f ? q - 1.0f + cr : q - cr);
}

// _cross_coord: coordinate along a non-crossed axis at candidate time t
HD int cross_coord(float o, float d, float t, bool tie_crossed) {
    return snap_coord(o, d, o + t * d, false, t, tie_crossed);
}

// _entry_candidate: coordinate at the entry time, planes crossed at or
// before t_in + 1e-9 count as crossed
HD int entry_coord(float o, float d, float t_in) {
    return snap_coord(o, d, o + t_in * d, true, t_in + 1e-9f, false);
}

HD bool occ_bit(const PhaseAParams& p, const int l[3]) {
    const int64_t widx = ((int64_t)l[0] * (p.reso[1] - 1) + l[1]) * p.W + (l[2] >> 5);
    return (p.words[widx] >> (l[2] & 31)) & 1u;
}

// far_t of voxel l's slab (voxel_plane_ts), capped at tmax
HD float slab_far_t(const float o[3], const float d[3], const int l[3], float tmax) {
    float ft = INFINITY;
    for (int a = 0; a < 3; ++a) {
        const float plane = (float)l[a] + (d[a] < 0.0f ? 0.0f : 1.0f);
        float f = (plane - o[a]) / safe_dir(d[a]);
        if (!finite(f)) f = INFINITY;
        ft = fminf(ft, f);
    }
    return fminf(ft, tmax);
}

// one candidate: count it if occupied, emit it unless degenerate
template <bool WRITE>
HD void visit(const PhaseAParams& p, const float o[3], const float d[3], float tmax, float t,
              const int l[3], int r, int& n_occ, int64_t& pos, const PoolOut& out) {
    for (int a = 0; a < 3; ++a)
        if (l[a] < 0 || l[a] > p.reso[a] - 2) return;
    if (!occ_bit(p, l)) return;
    ++n_occ;
    const float far = slab_far_t(o, d, l, tmax);
    if (!(far > t + 1e-9f)) return;
    if (WRITE) {
        out.ray_id[pos] = r;
        out.l[3 * pos + 0] = l[0];
        out.l[3 * pos + 1] = l[1];
        out.l[3 * pos + 2] = l[2];
        out.close_t[pos] = t;
        out.far_t[pos] = far;
    }
    ++pos;
}

HD float plane_t(int q, float o, float d) { return ((float)q - o) / d; }

// Walk ray r's candidates in t order. Returns the occupied-candidate count;
// pos advances by the number of entries (written at pos when WRITE). With
// CAPPED the walk stops once pos reaches end.
template <bool WRITE, bool CAPPED = false>
HD int walk_ray(const PhaseAParams& p, int r, int64_t& pos, const PoolOut& out,
                int64_t end = 0) {
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    const float tn = p.tnear[r], tx = p.tmax[r];
    const float lo = tn + 1e-9f, hi = tx - 1e-9f;
    int n_occ = 0;

    if (tx > lo) {
        const int l[3] = {entry_coord(o[0], d[0], tn), entry_coord(o[1], d[1], tn),
                          entry_coord(o[2], d[2], tn)};
        visit<WRITE>(p, o, d, tx, tn, l, r, n_occ, pos, out);
    }

    // per axis: the next plane in travel order and its crossing time; the
    // planes with lo < t < hi are a contiguous run, since t is monotone in p
    int q[3], step[3];
    float tq[3];
    bool live[3];
    for (int a = 0; a < 3; ++a) {
        live[a] = false;
        const int pmax = p.reso[a] - 2;
        if (d[a] == 0.0f || pmax < 1) continue;
        const float pos0 = o[a] + tn * d[a];
        const float guess = d[a] > 0.0f ? floorf(pos0) : ceilf(pos0);
        int k = (int)fminf(fmaxf(guess, 1.0f), (float)pmax);
        if (d[a] > 0.0f) {
            step[a] = 1;
            while (k > 1 && plane_t(k - 1, o[a], d[a]) > lo) --k;
            while (k <= pmax && !(plane_t(k, o[a], d[a]) > lo)) ++k;
            if (k > pmax) continue;
        } else {
            step[a] = -1;
            while (k < pmax && plane_t(k + 1, o[a], d[a]) > lo) ++k;
            while (k >= 1 && !(plane_t(k, o[a], d[a]) > lo)) --k;
            if (k < 1) continue;
        }
        const float t = plane_t(k, o[a], d[a]);
        if (!(t < hi)) continue;
        q[a] = k;
        tq[a] = t;
        live[a] = true;
    }

    while (!(CAPPED && pos >= end)) {
        int a = -1;
        for (int k = 0; k < 3; ++k)
            if (live[k] && (a < 0 || tq[k] < tq[a])) a = k;
        if (a < 0) break;
        const float t = tq[a];
        int l[3];
        for (int b = 0; b < 3; ++b)
            l[b] = b == a ? q[a] - (d[a] < 0.0f ? 1 : 0) : cross_coord(o[b], d[b], t, b < a);
        visit<WRITE>(p, o, d, tx, t, l, r, n_occ, pos, out);
        const int k = q[a] + step[a];
        if (k < 1 || k > p.reso[a] - 2) {
            live[a] = false;
            continue;
        }
        const float tk = plane_t(k, o[a], d[a]);
        if (!(tk < hi)) {
            live[a] = false;
            continue;
        }
        q[a] = k;
        tq[a] = tk;
    }
    return n_occ;
}

// ---------------------------------------------------------------------------
// K11a: the dense walk
// ---------------------------------------------------------------------------

// ops/dda.py:next_crossing for one ray: t of the next axis-plane crossing
HD float next_crossing(const float o[3], const float d[3], float t) {
    float best = INFINITY;
    for (int a = 0; a < 3; ++a) {
        const float pos = o[a] + t * d[a];
        const float tol = 2e-6f * (1.0f + fabsf(pos));
        const float fl = floorf(pos), ce = ceilf(pos);
        const float up = fabsf(ce - pos) <= tol ? ce + 1.0f : ce;
        const float dn = fabsf(fl - pos) <= tol ? fl - 1.0f : fl;
        const float step = ((d[a] >= 0.0f ? up : dn) - pos) / safe_dir(d[a]);
        if (!(step <= 0.0f) && d[a] != 0.0f && finite(step)) best = fminf(best, step);
    }
    return t + best;
}

// ops/dda.py:voxel_plane_ts: entry and exit t of voxel l's slab
HD void slab_ts(const float o[3], const float d[3], const int l[3], float& ct, float& ft) {
    ct = -INFINITY;
    ft = INFINITY;
    for (int a = 0; a < 3; ++a) {
        const float lf = (float)l[a];
        const bool neg = d[a] < 0.0f;
        float c = (lf + (neg ? 1.0f : 0.0f) - o[a]) / safe_dir(d[a]);
        float f = (lf + (neg ? 0.0f : 1.0f) - o[a]) / safe_dir(d[a]);
        if (!finite(c)) c = -INFINITY;
        if (!finite(f)) f = INFINITY;
        ct = fmaxf(ct, c);
        ft = fminf(ft, f);
    }
}

// Walk ray r as the JAX dense walk does; returns the number of entries,
// written from pos when WRITE.
template <bool WRITE>
HD int dense_walk_ray(const PhaseAParams& p, const bool* ray_ok, int max_voxels, int r,
                      int64_t pos, const PoolOut& out, int* steps = nullptr) {
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    const float tx = p.tmax[r];
    float t = p.tnear[r];  // 0 where the ray misses
    bool alive = ray_ok[r];
    int n = 0;
    for (int step = 0; step < max_voxels && alive; ++step) {
        const float nt = next_crossing(o, d, t);
        const bool has_next = finite(nt);
        const bool seg_ok = has_next && t < tx - 1e-9f;
        const float nts = has_next ? nt : t + 1.0f;
        if (seg_ok) {
            const float tm = 0.5f * (t + nts);
            int l[3];
            bool in_bounds = true;
            for (int a = 0; a < 3; ++a) {
                const float f = floorf(o[a] + tm * d[a]);
                in_bounds = in_bounds && f >= 0.0f && f <= (float)(p.reso[a] - 2);
                l[a] = in_bounds ? (int)f : 0;
            }
            if (in_bounds && occ_bit(p, l)) {
                if (WRITE) {
                    const int64_t k = pos + n;
                    float ct, ft;
                    slab_ts(o, d, l, ct, ft);
                    out.ray_id[k] = r;
                    for (int a = 0; a < 3; ++a) out.l[3 * k + a] = l[a];
                    out.close_t[k] = ct;
                    out.far_t[k] = ft;
                    if (steps) steps[k] = step;
                }
                ++n;
            }
        }
        alive = nts < tx + 1e-6f && has_next;
        if (seg_ok) t = nts;
    }
    return n;
}

#ifdef __CUDACC__
__global__ void dense_walk_count_kernel(PhaseAParams p, const bool* ray_ok, int max_voxels,
                                        int B, int* n) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const PoolOut none{nullptr, nullptr, nullptr, nullptr};
    n[r] = dense_walk_ray<false>(p, ray_ok, max_voxels, r, 0, none);
}

__global__ void dense_walk_fill_kernel(PhaseAParams p, const bool* ray_ok, int max_voxels, int B,
                                       const int64_t* offsets, PoolOut out, int* steps) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    dense_walk_ray<true>(p, ray_ok, max_voxels, r, offsets[r], out, steps);
}

__global__ void compact_fill_kernel(PhaseAParams p, int B, const int64_t* offsets, PoolOut out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    int64_t pos = offsets[r];
    walk_ray<true, true>(p, r, pos, out, offsets[r + 1]);
}

__global__ void phase_a_count_kernel(PhaseAParams p, int B, int* n_occupied, int* n_valid) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    int64_t pos = 0;
    const PoolOut none{nullptr, nullptr, nullptr, nullptr};
    n_occupied[r] = walk_ray<false>(p, r, pos, none);
    n_valid[r] = (int)pos;
}

__global__ void phase_a_fill_kernel(PhaseAParams p, int B, const int64_t* offsets, PoolOut out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    int64_t pos = offsets[r];
    walk_ray<true>(p, r, pos, out);
}

static PhaseAParams make_params(const float* origins, const float* dirs, const float* tnear,
                                const float* tmax, const int* words, int X, int Y, int Z) {
    return PhaseAParams{origins, dirs, tnear, tmax, reinterpret_cast<const unsigned*>(words),
                        {X, Y, Z}, (Z - 1 + 31) / 32};
}

extern "C" cudaError_t phase_a_count(const float* origins, const float* dirs, const float* tnear,
                                     const float* tmax, const int* words, int B, int X, int Y,
                                     int Z, int* n_occupied, int* n_valid, void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    phase_a_count_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, tnear, tmax, words, X, Y, Z), B, n_occupied, n_valid);
    return cudaGetLastError();
}

extern "C" cudaError_t phase_a_fill(const float* origins, const float* dirs, const float* tnear,
                                    const float* tmax, const int* words, int B, int X, int Y,
                                    int Z, const int64_t* offsets, int* ray_id, int* l,
                                    float* close_t, float* far_t, void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    phase_a_fill_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, tnear, tmax, words, X, Y, Z), B, offsets,
        PoolOut{ray_id, l, close_t, far_t});
    return cudaGetLastError();
}

extern "C" cudaError_t compact_fill(const float* origins, const float* dirs, const float* tnear,
                                    const float* tmax, const int* words, int B, int X, int Y,
                                    int Z, const int64_t* offsets, int* ray_id, int* l,
                                    float* close_t, float* far_t, void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    compact_fill_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, tnear, tmax, words, X, Y, Z), B, offsets,
        PoolOut{ray_id, l, close_t, far_t});
    return cudaGetLastError();
}

extern "C" cudaError_t dense_walk_count(const float* origins, const float* dirs, const float* t0,
                                        const float* tmax, const bool* ray_ok, const int* words,
                                        int B, int X, int Y, int Z, int max_voxels, int* n,
                                        void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    dense_walk_count_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, t0, tmax, words, X, Y, Z), ray_ok, max_voxels, B, n);
    return cudaGetLastError();
}

extern "C" cudaError_t dense_walk_fill(const float* origins, const float* dirs, const float* t0,
                                       const float* tmax, const bool* ray_ok, const int* words,
                                       int B, int X, int Y, int Z, int max_voxels,
                                       const int64_t* offsets, int* ray_id, int* l,
                                       float* close_t, float* far_t, int* steps, void* stream) {
    if (B <= 0) return cudaSuccess;
    const int block = 128;
    dense_walk_fill_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, t0, tmax, words, X, Y, Z), ray_ok, max_voxels, B, offsets,
        PoolOut{ray_id, l, close_t, far_t}, steps);
    return cudaGetLastError();
}
#endif
