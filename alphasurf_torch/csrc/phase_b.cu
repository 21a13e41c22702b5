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
// and writes S0 slots of t, alpha, rgb, snorm and flags. Design: one
// thread per entry; the corner colours are contracted with the ray's SH
// basis while each row streams in, so a thread keeps 8 alphas, 8 surface
// values and 8x3 colours in registers instead of 8x32 floats.
//
// Outputs keep the JAX package's layout: slot arrays (S0, M), vectors
// (3, S0, M), loss sums (3, M), (5, M) for the UDF types. The per-entry math is in samples.cuh,
// which K5b (backward.cu) shares to recompute the samples it
// differentiates.
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

HD void phase_b_entry(const PhaseBParams& p, int64_t m) {
    const int r = p.ray_id[m];
    const int l[3] = {p.l[3 * m], p.l[3 * m + 1], p.l[3 * m + 2]};
    const float close_t = p.close_t[m], far_t = p.far_t[m];
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = p.origins[3 * (int64_t)r + a];
        d[a] = p.dirs[3 * (int64_t)r + a];
    }
    Corners cs;
    gather_corners(p.links, p.X, p.Y, p.Z, p.packed, p.cap, p.C8, p.n_surf_c, p.bd,
                   p.sh_mult + (int64_t)r * p.bd, p.sigma_thresh, p.stype, l, cs);
    SlotSums sums;
    const float zero3[3] = {0.0f, 0.0f, 0.0f};

    if (p.stype == SURF_VOXEL_FACE) {
        FaceSlot f;
        face_slot(cs, o, d, l, close_t, p.near_grid_t, p.X, p.Y, p.Z, f);
        float rgb[3];
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(f.pre_rgb[ch], 0.0f);
        write_slot(p, m, 0, close_t, f.alpha, rgb, f.contrib, false, f.contrib ? 1 : 0, zero3);
        add_slot_losses(sums, f.contrib, f.alpha, zero3, d);
        write_losses(p, m, sums);
        return;
    }
    if (p.stype == SURF_PLANE) {
        float pl[4];
        mean_plane(p.packed, p.cap, p.C8, cs, pl);
        PlaneRoot q;
        plane_root(pl, o, d, l, q);
        RealSlot s;
        real_slot(cs, o, d, l, close_t, q.t_pl - close_t, cs.vox_ok && q.t_pl > 0.0f,
                  p.near_grid_t, p.only_outward, q.abc, s);
        float rgb[3];
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(s.pre_rgb[ch], 0.0f);
        const bool contrib = s.geo_ok && s.raw > p.sigma_thresh;
        const float alpha = alpha_act(s.raw, p.act_sigmoid);
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

    bool vox_has_sample = false, vox_has_surf = false;
    int n_lv_hull = 0;
    for (int i = 0; i < p.n_lv; ++i) {
        const float lv = p.level_sets[i];
        const bool lv_ok = cs.vox_ok && lv >= smin && lv <= smax;
        vox_has_surf = vox_has_surf || lv_ok;
        n_lv_hull += lv_ok ? 1 : 0;
        float roots[3];
        bool has[3];
        cubic_roots(f[0] - lv, f[1], f[2], f[3], roots, has);
        for (int j = 0; j < 3; ++j) {
            RealSlot s;
            real_slot(cs, o, d, l, close_t, roots[j], lv_ok, p.near_grid_t, p.only_outward,
                      nullptr, s);
            if (p.lv_alpha) s.raw = p.lv_alpha[i];  // UDF_ALPHA: the level set's alpha
            vox_has_sample = vox_has_sample || s.geo_pre;
            float rgb[3];
            for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(s.pre_rgb[ch], 0.0f);
            const bool contrib = s.geo_ok && s.raw > p.sigma_thresh;
            const float alpha = alpha_act(s.raw, p.act_sigmoid);
            write_slot(p, m, 3 * i + j, s.t, alpha, rgb, contrib, false, s.geo_ok ? 1 : 0, s.sn);
            add_slot_losses(sums, contrib, alpha, s.sn, d);
        }
    }

    if (p.fake_sample) {
        FakeSlot fs;
        fake_slot(cs, o, d, l, close_t, far_t, vox_has_sample, vox_has_surf, p.min_vox_len,
                  p.limited_fake, p.normalize_surf, p.level_sets, p.n_lv, p.sigma_thresh,
                  p.fs_std ? p.fs_std[0] : 1.0f, p.act_sigmoid, p.lv_alpha, fs);
        float frgb[3];
        for (int ch = 0; ch < 3; ++ch) frgb[ch] = fmaxf(fs.pre_rgb[ch], 0.0f);
        write_slot(p, m, p.S0 - 1, fs.tf, fs.falpha, frgb, fs.take, true, 0, zero3);
        add_slot_losses(sums, fs.take, fs.falpha, fs.fsn, d);
    }
    write_losses(p, m, sums);
    if (is_udf(p.stype)) {
        float mu;
        const float var = udf_var(cs.surf8, mu);
        const float k = udf_hull_factor(p.stype, n_lv_hull, p.n_lv, p.fake_sample, p.limited_fake);
        p.loss_e[3 * p.M + m] = cs.vox_ok ? k * var : 0.0f;
        p.loss_e[4 * p.M + m] = cs.vox_ok ? 1.0f : 0.0f;
    }
}

#ifdef __CUDACC__
__global__ void phase_b_kernel(PhaseBParams p) {
    const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (m < p.M) phase_b_entry(p, m);
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
    const PhaseBParams p{ray_id, l, close_t, far_t, M, origins, dirs, sh_mult, bd, links,
                         X, Y, Z, packed, cap, C8, n_surf_c, level_sets, n_lv, S0,
                         stype, lv_alpha, near_grid_t, sigma_thresh, fs_std, min_vox_len,
                         only_outward, fake_sample, limited_fake, normalize_surf, act_sigmoid,
                         t, alpha, contrib, fake, counted, rgb, snorm, loss_e};
    const int block = 128;
    phase_b_kernel<<<(unsigned)((M + block - 1) / block), block, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}
#endif
