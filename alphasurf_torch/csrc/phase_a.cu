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
// Design: a count kernel, an exclusive scan of the counts outside any
// kernel, and a fill kernel that walks the same candidates and writes each
// ray's entries from its offset. The pool is sized exactly (no budget, no
// overflow) and needs no sort: entries come out ray-major and t-ascending,
// the entry candidate first, equal t on two axes lower axis first (the
// order a stable sort of the plain version's candidate list gives).
//
// A warp walks one ray (walk_warp), 32 candidates a window. Every
// candidate's voxel and slab are closed-form in its t, so a lane evaluates
// any candidate with the same expressions in the same order whatever the
// lane. In a window lane j holds the time of the j-th next plane of each
// axis; an element's merged rank is its index on its axis plus, for each
// other axis, the count of that axis's times below it (at equal t the
// lower axis counts as below), found by a binary search over the lanes by
// shuffles. The elements of rank < 32 go through shared memory to lane
// rank, which tests occupancy and the sliver; a ballot of the kept lanes
// gives each entry's slot, so a window's entries go to consecutive slots
// and each array is written coalesced. A warp a ray keeps the SMs full (a
// 16,384-ray serving chunk is 16,384 warps, where a thread a ray made 4
// warps an SM) and its lanes never wait on another ray's length. Measured
// slower on the H100 (PERF.md): groups of 8 or 16 lanes a ray, and one
// plane a lane with the lanes split among the axes by |d| (fewer shuffles,
// more selects and lane masks).
//
// Bound: operations. A window costs each lane three plane times, six
// searches of six shuffles, two corner-snap coordinates, a lookup
// in the occupancy words (16 MB at 512^3, held in the 50 MB L2) and, where
// occupied, three slab divisions. Bytes moved are the rays in and the pool
// out. The supervoxel prefilter of the JAX version is left out (it changes
// no voxel of the set).
//
// K11b, compact_fill: the first K entries of each ray, the JAX package's
// compact_crossings (render/surface.py:1284) over all_crossings (1237). The
// count pass is K2's (its n_valid is JAX's uncapped n_occupied); the scan
// runs over min(n_valid, K), and the fill is K2's walk, writing only the
// slots below the ray's end offset and stopping there.
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

HD float plane_t(int q, float o, float d) { return ((float)q - o) / d; }

// The first plane of one axis in travel order with lo < t, if its t < hi
// (live). The planes with lo < t < hi are a contiguous run from it, since t
// is monotone in the plane.
struct AxisRun {
    int q, step;
    bool live;
};

HD AxisRun first_plane(float o, float d, float tn, float lo, float hi, int pmax) {
    AxisRun run{0, d < 0.0f ? -1 : 1, false};
    if (d == 0.0f || pmax < 1) return run;
    const float pos0 = o + tn * d;
    const float guess = d > 0.0f ? floorf(pos0) : ceilf(pos0);
    int k = (int)fminf(fmaxf(guess, 1.0f), (float)pmax);
    if (d > 0.0f) {
        while (k > 1 && plane_t(k - 1, o, d) > lo) --k;
        while (k <= pmax && !(plane_t(k, o, d) > lo)) ++k;
        if (k > pmax) return run;
    } else {
        while (k < pmax && plane_t(k + 1, o, d) > lo) ++k;
        while (k >= 1 && !(plane_t(k, o, d) > lo)) --k;
        if (k < 1) return run;
    }
    run.q = k;
    run.live = plane_t(k, o, d) < hi;
    return run;
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

// ---------------------------------------------------------------------------
// K2's walk: a warp a ray
// ---------------------------------------------------------------------------

constexpr int kPhaseABlock = 128;

// the number of the warp's lanes whose v is below t (v <= t with le); v
// ascends over the lanes. Every lane calls it.
__device__ __forceinline__ int lanes_below(float v, float t, bool le) {
    int n = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const float u = __shfl_sync(kFullWarp, v, n + s - 1);
        if (le ? u <= t : u < t) n += s;
    }
    const float u = __shfl_sync(kFullWarp, v, n);
    return n + ((le ? u <= t : u < t) ? 1 : 0);
}

// Walk ray r's candidates in t order, 32 a window, with every lane of the
// warp. Returns the occupied-candidate count; pos advances by the number
// of entries (written from pos when WRITE). With CAPPED only the slots
// below end are written and the walk stops there. s_t and s_qa are the
// warp's 32 slots of shared memory.
template <bool WRITE, bool CAPPED>
__device__ int walk_warp(const PhaseAParams& p, int r, int64_t& pos, const PoolOut& out,
                         int64_t end, float* s_t, int* s_qa) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    const float tn = p.tnear[r], tx = p.tmax[r];
    const float lo = tn + 1e-9f, hi = tx - 1e-9f;
    // bit b: d[b] < 0 (a bit mask, not d[a] at a lane-dependent a, which
    // the compiler reads from local memory)
    const int neg = (d[0] < 0.0f ? 1 : 0) | (d[1] < 0.0f ? 2 : 0) | (d[2] < 0.0f ? 4 : 0);
    AxisRun run[3];
    for (int a = 0; a < 3; ++a) run[a] = first_plane(o[a], d[a], tn, lo, hi, p.reso[a] - 2);
    int entry = tx > lo ? 1 : 0;  // the entry candidate leads the first window
    int n_occ = 0;

    for (;;) {
        // lane j: the j-th next plane of each axis, t = inf past the run
        float ta[3];
        int ka[3], nv[3];
        int n_win = entry;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            ka[a] = run[a].q + run[a].step * lane;
            ta[a] = INFINITY;
            if (run[a].live && ka[a] >= 1 && ka[a] <= p.reso[a] - 2) {
                const float t = plane_t(ka[a], o[a], d[a]);
                if (t < hi) ta[a] = t;
            }
            nv[a] = __popc(__ballot_sync(kFullWarp, ta[a] < INFINITY));
            n_win += nv[a];
        }
        n_win = min(n_win, 32);
        if (n_win == 0) break;
        // merged rank: lower axes count as below at equal t
        int took[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            int rank = entry + lane;
#pragma unroll
            for (int b = 0; b < 3; ++b)
                if (b != a) rank += lanes_below(ta[b], ta[a], b < a);
            const bool sel = ta[a] < INFINITY && rank < 32;
            if (sel) {
                s_t[rank] = ta[a];
                s_qa[rank] = ka[a] * 4 + a;
            }
            took[a] = __popc(__ballot_sync(kFullWarp, sel));
        }
        if (entry && lane == 0) {
            s_t[0] = tn;
            s_qa[0] = 3;
        }
        __syncwarp();
        // lane j: the window's j-th candidate
        bool occ = false, keep = false;
        float t = 0.0f, far = 0.0f;
        int l[3] = {0, 0, 0};
        if (lane < n_win) {
            t = s_t[lane];
            const int qa = s_qa[lane], a = qa & 3;
            bool in = true;
            for (int b = 0; b < 3; ++b) {
                l[b] = a == 3 ? entry_coord(o[b], d[b], tn)
                       : b == a ? (qa >> 2) - ((neg >> b) & 1)
                                : cross_coord(o[b], d[b], t, b < a);
                in = in && l[b] >= 0 && l[b] <= p.reso[b] - 2;
            }
            occ = in && occ_bit(p, l);
            if (occ) {
                far = slab_far_t(o, d, l, tx);
                keep = far > t + 1e-9f;
            }
        }
        __syncwarp();  // the slots are read before the next window writes them
        n_occ += __popc(__ballot_sync(kFullWarp, occ));
        const unsigned kept = __ballot_sync(kFullWarp, keep);
        if (WRITE && keep) {
            const int64_t e = pos + __popc(kept & below);
            if (!CAPPED || e < end) {
                out.ray_id[e] = r;
                out.l[3 * e + 0] = l[0];
                out.l[3 * e + 1] = l[1];
                out.l[3 * e + 2] = l[2];
                out.close_t[e] = t;
                out.far_t[e] = far;
            }
        }
        pos += __popc(kept);
        if (CAPPED && pos >= end) break;
        entry = 0;
        for (int a = 0; a < 3; ++a) {
            run[a].q += run[a].step * took[a];
            run[a].live = took[a] < nv[a] || nv[a] == 32;
        }
    }
    return n_occ;
}

__global__ void __launch_bounds__(kPhaseABlock)
phase_a_count_kernel(PhaseAParams p, int B, int* n_occupied, int* n_valid) {
    __shared__ float s_t[kPhaseABlock];
    __shared__ int s_qa[kPhaseABlock];
    const int64_t r = ((int64_t)blockIdx.x * kPhaseABlock + threadIdx.x) / 32;
    if (r >= B) return;
    const int w = threadIdx.x & ~31;
    int64_t pos = 0;
    const PoolOut none{nullptr, nullptr, nullptr, nullptr};
    const int n_occ = walk_warp<false, false>(p, (int)r, pos, none, 0, s_t + w, s_qa + w);
    if ((threadIdx.x & 31) == 0) {
        n_occupied[r] = n_occ;
        n_valid[r] = (int)pos;
    }
}

// CAPPED: K11b, each ray's slots end at offsets[r + 1]
template <bool CAPPED>
__global__ void __launch_bounds__(kPhaseABlock)
phase_a_fill_kernel(PhaseAParams p, int B, const int64_t* offsets, PoolOut out) {
    __shared__ float s_t[kPhaseABlock];
    __shared__ int s_qa[kPhaseABlock];
    const int64_t r = ((int64_t)blockIdx.x * kPhaseABlock + threadIdx.x) / 32;
    if (r >= B) return;
    const int w = threadIdx.x & ~31;
    int64_t pos = offsets[r];
    walk_warp<true, CAPPED>(p, (int)r, pos, out, CAPPED ? offsets[r + 1] : 0, s_t + w, s_qa + w);
}

// a warp a ray
static int warp_blocks(int B) {
    return (int)(((int64_t)B * 32 + kPhaseABlock - 1) / kPhaseABlock);
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
    phase_a_count_kernel<<<warp_blocks(B), kPhaseABlock, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, tnear, tmax, words, X, Y, Z), B, n_occupied, n_valid);
    return cudaGetLastError();
}

extern "C" cudaError_t phase_a_fill(const float* origins, const float* dirs, const float* tnear,
                                    const float* tmax, const int* words, int B, int X, int Y,
                                    int Z, const int64_t* offsets, int* ray_id, int* l,
                                    float* close_t, float* far_t, void* stream) {
    if (B <= 0) return cudaSuccess;
    phase_a_fill_kernel<false><<<warp_blocks(B), kPhaseABlock, 0, (cudaStream_t)stream>>>(
        make_params(origins, dirs, tnear, tmax, words, X, Y, Z), B, offsets,
        PoolOut{ray_id, l, close_t, far_t});
    return cudaGetLastError();
}

extern "C" cudaError_t compact_fill(const float* origins, const float* dirs, const float* tnear,
                                    const float* tmax, const int* words, int B, int X, int Y,
                                    int Z, const int64_t* offsets, int* ray_id, int* l,
                                    float* close_t, float* far_t, void* stream) {
    if (B <= 0) return cudaSuccess;
    phase_a_fill_kernel<true><<<warp_blocks(B), kPhaseABlock, 0, (cudaStream_t)stream>>>(
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
