// K3: phase B, the samples of each pool entry.
//
// Replaces the JAX package's render/surface.py:_voxel_samples_T (469-734) and
// _accumulate_sample_losses_T (737-770) for every surface type, with
// ops/cubic.py:cubic_coeffs_T and _cubic_roots_raw (Vieta roots plus two
// clamped Newton steps) and ops/trilerp.py:trilerp_weights_T. Per entry:
// one gather of the 8 corner rows, the cubic of the trilinear surface
// along the ray for each level set, its real roots inside the voxel (with
// the outward-only filter), a limited fake sample at mid-segment with a
// Gaussian reweight when no root is kept, alpha, SH colour, normal, and
// the entry's inward-norm and density-lap sums. The surface types'
// branches (stype): the UDF types take the softplus of their corner values
// and add the udf-var sum and count (loss_e's rows 3 and 4); UDF_ALPHA
// reads each slot's raw alpha from its level set's row of lv_alpha, the
// fake sample's from the nearest level set's, and has no corner-alpha gate;
// PLANE takes the one root of the corners' mean plane, with the plane's
// normal and no fake sample (S0 = 1); VOXEL_FACE one sample where the ray
// enters the voxel (S0 = 1).
//
// Bound: bytes. Each entry reads 8 rows of C8 = 32 floats (1 KB, random
// rows of the capacity-sized table, neighbouring entries share corners)
// and writes S0 slots of t, alpha, rgb, snorm and flags.
//
// Design (the H100): an entry is a group of G lanes (G = 4: a warp holds 8
// entries). Lane c reads corner c's link and then its row (corner c + 4
// too at G = 4) in 16-byte loads and contracts the colour with the ray's
// basis, so a load instruction of the warp reads 16 bytes of each of 32
// rows (basis_dim 9, the SH rows: the row's layout is known at compile
// time and sits in registers; other bases take it element by element).
// The group then hands every lane the 8 corners' alpha, surface value
// and colour by shuffles, and lane j computes slot j: root j mod 3
// of level set j / 3 (S0 > G: lane j takes slots j, j + G, ...); the fake
// sample follows on every lane, once a ballot has told the group whether
// any real slot kept a root, and the lane of slot S0 - 1 writes it. The
// entry's loss sums are added in slot order, so loss_e keeps the serial
// walk's bits, as t, alpha and the flags keep theirs: every slot is
// computed by the same expressions as before (--fmad=false). The kernel
// is a template on the surface type, so each type's branches cost the
// others nothing. The group's row reader (gather_corners_lanes, over
// corner_row), the roots (cubic_root) and the mean plane are samples.cuh's,
// which K5b also calls.
//
// Outputs keep the JAX package's layout: slot arrays (S0, M), vectors
// (3, S0, M), loss sums (3, M), (5, M) for the UDF types. The per-entry
// math is in samples.cuh, which K5b (backward.cu) shares to recompute the
// samples it differentiates.
#include "samples.cuh"


struct PhaseBParams {
    const int* ray_id;
    const int* l;
    const float* close_t;
    const float* far_t;
    int64_t M;
    const float* origins;
    const float* dirs;
    const float* sh_mult;
    int bd;
    const int* links;
    int X, Y, Z;
    const float* packed;
    int cap, C8, n_surf_c;
    const float* level_sets;
    int n_lv;
    int S0;
    int stype;
    const float* lv_alpha;  // UDF_ALPHA's (n_lv,) alphas, else null
    float near_grid_t, sigma_thresh;
    const float* fs_std;  // (1,) on the device, or null for 1
    float min_vox_len;
    int only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid;
    float* t;
    float* alpha;
    bool* contrib;
    bool* fake;
    int* counted;
    float* rgb;
    float* snorm;
    float* loss_e;
};

struct SlotSums {
    float inward = 0.0f, lap = 0.0f, lap_cnt = 0.0f;
};

HD void write_slot(const PhaseBParams& p, int64_t m, int s, float t, float alpha, const float rgb[3],
                   bool contrib, bool fake, int counted, const float sn[3]) {
    const int64_t i = (int64_t)s * p.M + m;
    p.t[i] = t;
    p.alpha[i] = alpha;
    p.contrib[i] = contrib;
    p.fake[i] = fake;
    p.counted[i] = counted;
    for (int k = 0; k < 3; ++k) {
        p.rgb[((int64_t)k * p.S0 + s) * p.M + m] = rgb[k];
        p.snorm[((int64_t)k * p.S0 + s) * p.M + m] = sn[k];
    }
}

// the inward-norm and density-lap terms of one slot (normal sn_in)
HD void add_slot_losses(SlotSums& acc, bool contrib, float alpha, const float sn_in[3], const float d[3]) {
    acc.inward = acc.inward + (contrib ? alpha * inward_sq(sn_in, d) : 0.0f);
    acc.lap = acc.lap + (contrib ? lap_term(alpha) : 0.0f);
    acc.lap_cnt = acc.lap_cnt + (contrib ? 1.0f : 0.0f);
}

HD void write_losses(const PhaseBParams& p, int64_t m, const SlotSums& sums) {
    p.loss_e[m] = sums.inward;
    p.loss_e[p.M + m] = sums.lap;
    p.loss_e[2 * p.M + m] = sums.lap_cnt;
}

#ifdef __CUDACC__
constexpr int kK3Block = 128;
constexpr int kK3MinBlocks = 5;  // blocks an SM the kernel is compiled for (<= 96 registers)

template <int kType, int kBd>
__global__ void __launch_bounds__(kK3Block, kK3MinBlocks) phase_b_kernel(PhaseBParams p) {
    constexpr int G = kK3Lanes;
    const int lane = threadIdx.x & 31, lg = lane & (G - 1);
    const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if ((gid - lane) / G >= p.M) return;  // the whole warp is past the last entry
    // a group past the last entry works on it and writes nothing
    const bool valid = gid / G < p.M;
    const int64_t m = valid ? gid / G : p.M - 1;
    const int r = p.ray_id[m];
    const int l[3] = {p.l[3 * m], p.l[3 * m + 1], p.l[3 * m + 2]};
    const float close_t = p.close_t[m], far_t = p.far_t[m];
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    Corners cs;
    float pl[4];
    gather_corners_lanes<kType, kBd>(p, p.sh_mult + (int64_t)r * p.bd, l, lane, cs, pl);
    const bool writer = valid && lg == 0;
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    SlotSums sums;

    if constexpr (kType == SURF_VOXEL_FACE) {
        FaceSlot f;
        face_slot(cs, o, d, l, close_t, p.near_grid_t, p.X, p.Y, p.Z, f);
        float rgb[3];
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(f.pre_rgb[ch], 0.0f);
        if (!writer) return;
        write_slot(p, m, 0, close_t, f.alpha, rgb, f.contrib, false, f.contrib ? 1 : 0, zero3);
        add_slot_losses(sums, f.contrib, f.alpha, zero3, d);
        write_losses(p, m, sums);
        return;
    }
    if constexpr (kType == SURF_PLANE) {
        PlaneRoot q;
        plane_root(pl, o, d, l, q);
        RealSlot s;
        real_slot(cs, o, d, l, close_t, q.t_pl - close_t, cs.vox_ok && q.t_pl > 0.0f,
                  p.near_grid_t, p.only_outward, q.abc, s);
        float rgb[3];
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(s.pre_rgb[ch], 0.0f);
        const bool contrib = s.geo_ok && s.raw > p.sigma_thresh;
        const float alpha = alpha_act(s.raw, p.act_sigmoid);
        if (!writer) return;
        write_slot(p, m, 0, s.t, alpha, rgb, contrib, false, s.geo_ok ? 1 : 0, s.sn);
        add_slot_losses(sums, contrib, alpha, s.sn, d);
        write_losses(p, m, sums);
        return;
    }

    float smin = cs.surf8[0], smax = cs.surf8[0];
    for (int c = 1; c < 8; ++c) {
        smin = fminf(smin, cs.surf8[c]);
        smax = fmaxf(smax, cs.surf8[c]);
    }
    float u[3], f[4];
    for (int a = 0; a < 3; ++a) u[a] = o[a] + close_t * d[a] - (float)l[a];
    cubic_coeffs(cs.surf8, u, d, f);

    // lane j: slot j = root j mod 3 of level set j / 3 (and j + G, ...)
    const int n_real = 3 * p.n_lv;
    bool has_sample = false, has_surf = false;
    int n_lv_hull = 0;
    for (int j0 = 0; j0 < n_real; j0 += G) {
        const int j = j0 + lg;
        const bool mine = j < n_real;
        const int i = mine ? j / 3 : 0;
        const int jr = j - 3 * i;
        const float lv = p.level_sets[i];
        const bool lv_ok = cs.vox_ok && lv >= smin && lv <= smax;
        bool has;
        const float root = cubic_root(f[0] - lv, f[1], f[2], f[3], jr, has);
        RealSlot s;
        real_slot(cs, o, d, l, close_t, root, lv_ok, p.near_grid_t, p.only_outward, nullptr, s);
        if (kType == SURF_UDF_ALPHA) s.raw = p.lv_alpha[i];  // the level set's alpha
        float rgb[3];
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(s.pre_rgb[ch], 0.0f);
        const bool contrib = mine && s.geo_ok && s.raw > p.sigma_thresh;
        const float alpha = alpha_act(s.raw, p.act_sigmoid);
        if (mine && valid) write_slot(p, m, j, s.t, alpha, rgb, contrib, false, s.geo_ok ? 1 : 0, s.sn);
        has_sample = has_sample || (mine && s.geo_pre);
        has_surf = has_surf || (mine && lv_ok);
        n_lv_hull += mine && jr == 0 && lv_ok ? 1 : 0;
        // the slots' loss terms, added in slot order in every lane
        SlotSums one;
        add_slot_losses(one, contrib, alpha, s.sn, d);
#pragma unroll
        for (int src = 0; src < G; ++src) {
            const float vi = __shfl_sync(kFullWarp, one.inward, src, G);
            const float vl = __shfl_sync(kFullWarp, one.lap, src, G);
            const float vc = __shfl_sync(kFullWarp, one.lap_cnt, src, G);
            if (j0 + src < n_real) {
                sums.inward = sums.inward + vi;
                sums.lap = sums.lap + vl;
                sums.lap_cnt = sums.lap_cnt + vc;
            }
        }
    }
    has_sample = segment_bits<G>(__ballot_sync(kFullWarp, has_sample), lane) != 0u;
    has_surf = segment_bits<G>(__ballot_sync(kFullWarp, has_surf), lane) != 0u;
    n_lv_hull = warp_allsum<G>(n_lv_hull);

    if (p.fake_sample) {  // on every lane; slot S0 - 1's lane writes it
        FakeSlot fs;
        fake_slot(cs, o, d, l, close_t, far_t, has_sample, has_surf, p.min_vox_len,
                  p.limited_fake, p.normalize_surf, p.level_sets, p.n_lv, p.sigma_thresh,
                  p.fs_std ? p.fs_std[0] : 1.0f, p.act_sigmoid, p.lv_alpha, fs);
        float frgb[3];
        for (int ch = 0; ch < 3; ++ch) frgb[ch] = fmaxf(fs.pre_rgb[ch], 0.0f);
        if (valid && lg == (p.S0 - 1) % G)
            write_slot(p, m, p.S0 - 1, fs.tf, fs.falpha, frgb, fs.take, true, 0, zero3);
        add_slot_losses(sums, fs.take, fs.falpha, fs.fsn, d);
    }
    if (!writer) return;
    write_losses(p, m, sums);
    if (is_udf(kType)) {
        float mu;
        const float var = udf_var(cs.surf8, mu);
        const float k = udf_hull_factor(kType, n_lv_hull, p.n_lv, p.fake_sample, p.limited_fake);
        p.loss_e[3 * p.M + m] = cs.vox_ok ? k * var : 0.0f;
        p.loss_e[4 * p.M + m] = cs.vox_ok ? 1.0f : 0.0f;
    }
}

// rows of basis_dim 9 (SH), laid out at compile time: C8 = 32 for every type
constexpr int kK3FixedBd = 9;

template <int kType>
cudaError_t launch_phase_b(const PhaseBParams& p, cudaStream_t stream) {
    const int64_t threads = p.M * kK3Lanes;
    const unsigned grid = (unsigned)((threads + kK3Block - 1) / kK3Block);
    constexpr int kShBase = 1 + (kType == SURF_PLANE ? 4 : 1);
    constexpr int kC8 = (kShBase + 3 * kK3FixedBd + 7) / 8 * 8;
    if (p.bd == kK3FixedBd && p.C8 == kC8 && p.n_surf_c == kShBase - 1)
        phase_b_kernel<kType, kK3FixedBd><<<grid, kK3Block, 0, stream>>>(p);
    else
        phase_b_kernel<kType, 0><<<grid, kK3Block, 0, stream>>>(p);
    return cudaGetLastError();
}

extern "C" cudaError_t phase_b(const int* ray_id, const int* l, const float* close_t,
                               const float* far_t, long long M, const float* origins,
                               const float* dirs, const float* sh_mult, int bd, const int* links,
                               int X, int Y, int Z, const float* packed, int cap, int C8,
                               int n_surf_c, const float* level_sets, int n_lv, int S0,
                               int stype, const float* lv_alpha, float near_grid_t,
                               float sigma_thresh, const float* fs_std, float min_vox_len,
                               int only_outward, int fake_sample, int limited_fake,
                               int normalize_surf, int act_sigmoid, float* t,
                               float* alpha, bool* contrib, bool* fake, int* counted, float* rgb,
                               float* snorm, float* loss_e, void* stream) {
    if (M <= 0) return cudaSuccess;
    // the rows are read in 16-byte loads
    if ((reinterpret_cast<uintptr_t>(packed) & 15u) != 0u || C8 % 4 != 0)
        return cudaErrorMisalignedAddress;
    const PhaseBParams p{ray_id, l, close_t, far_t, M, origins, dirs, sh_mult, bd, links,
                         X, Y, Z, packed, cap, C8, n_surf_c, level_sets, n_lv, S0,
                         stype, lv_alpha, near_grid_t, sigma_thresh, fs_std, min_vox_len,
                         only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid,
                         t, alpha, contrib, fake, counted, rgb, snorm, loss_e};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (stype) {
        case SURF_SDF: return launch_phase_b<SURF_SDF>(p, s);
        case SURF_UDF: return launch_phase_b<SURF_UDF>(p, s);
        case SURF_UDF_ALPHA: return launch_phase_b<SURF_UDF_ALPHA>(p, s);
        case SURF_UDF_FAKE_SAMPLE: return launch_phase_b<SURF_UDF_FAKE_SAMPLE>(p, s);
        case SURF_PLANE: return launch_phase_b<SURF_PLANE>(p, s);
        case SURF_VOXEL_FACE: return launch_phase_b<SURF_VOXEL_FACE>(p, s);
        default: return cudaErrorInvalidValue;
    }
}
#endif
