// The per-entry sample math of phase B, shared by K3 (phase_b.cu, forward)
// and K5b (backward.cu, which recomputes each entry's samples before it
// differentiates them). One copy of the arithmetic keeps the backward's
// recomputation bit-identical to the forward.
//
// JAX counterparts: render/surface.py:_voxel_samples_T (469-734),
// ops/cubic.py:cubic_coeffs_T and _cubic_roots_raw, ops/trilerp.py.
//
// The surface types (defs.py, svox2's values): SDF and the three UDF types
// are scalar fields with 3 root slots a level set (the UDF types' corner
// values pass through softplus; UDF_ALPHA reads a slot's raw alpha from its
// level set's row of an (n_lv,) table and has no corner-alpha gate); PLANE
// takes one root of the corners' mean plane; VOXEL_FACE one sample where
// the ray enters the voxel.
#pragma once

#include "common.cuh"

constexpr int SURF_PLANE = 101;
constexpr int SURF_SDF = 102;
constexpr int SURF_UDF = 103;
constexpr int SURF_UDF_ALPHA = 104;
constexpr int SURF_UDF_FAKE_SAMPLE = 105;
constexpr int SURF_VOXEL_FACE = 106;

HD bool is_udf(int stype) {
    return stype == SURF_UDF || stype == SURF_UDF_ALPHA || stype == SURF_UDF_FAKE_SAMPLE;
}

HD float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

HD float alpha_act(float raw, int sigmoid) {
    return sigmoid ? sigmoid_f(raw) : 1.0f - expf(-fmaxf(raw, 0.0f));
}

// d alpha_act / d raw; relu'(0) = 0 as jax.nn.relu
HD float alpha_act_grad(float raw, int sigmoid) {
    if (sigmoid) {
        const float a = 1.0f / (1.0f + expf(-raw));
        return a * (1.0f - a);
    }
    return raw > 0.0f ? expf(-raw) : 0.0f;
}

// ops/cubic.py:cubic_coeffs_T (linear in s)
HD void cubic_coeffs(const float s[8], const float u[3], const float v[3], float f[4]) {
    const float ux = u[0], uy = u[1], uz = u[2];
    const float vx = v[0], vy = v[1], vz = v[2];
    const float a00 = s[0] * (1.0f - uz) + s[1] * uz;
    const float a01 = s[2] * (1.0f - uz) + s[3] * uz;
    const float a10 = s[4] * (1.0f - uz) + s[5] * uz;
    const float a11 = s[6] * (1.0f - uz) + s[7] * uz;
    const float b00 = s[1] - s[0];
    const float b01 = s[3] - s[2];
    const float b10 = s[5] - s[4];
    const float b11 = s[7] - s[6];
    const float c0 = a00 * (1.0f - uy) + a01 * uy;
    const float c1 = a10 * (1.0f - uy) + a11 * uy;
    const float d0 = -(a00 * vy - vz * b00 * (1.0f - uy)) + (a01 * vy + vz * b01 * uy);
    const float d1 = -(a10 * vy - vz * b10 * (1.0f - uy)) + (a11 * vy + vz * b11 * uy);
    const float e0 = vy * vz * (b01 - b00);
    const float e1 = vy * vz * (b11 - b10);
    f[3] = (e1 - e0) * vx;
    f[2] = -d0 * vx + e0 * (1.0f - ux) + d1 * vx + e1 * ux;
    f[1] = -c0 * vx + d0 * (1.0f - ux) + c1 * vx + d1 * ux;
    f[0] = c0 * (1.0f - ux) + c1 * ux;
}

// Root j (0, 1 or 2) of ops/cubic.py:_cubic_roots_raw: -1 where it has
// none (has says which). Root j alone costs only its own cosine and Newton
// steps, as one lane of K3 computes one slot.
HD float cubic_root(float f0, float f1, float f2, float f3, int j, bool& has) {
    const bool is3 = fabsf(f3) >= 1e-10f;
    const bool is2 = !is3 && fabsf(f2) >= 1e-10f;
    const bool is1 = !is3 && !is2 && fabsf(f1) >= 1e-10f;
    const float t_lin = -f0 / (is1 ? f1 : 1.0f);

    const float qb = is2 ? f2 : 1.0f;
    const float D = f1 * f1 - 4.0f * f2 * f0;
    const bool has2 = is2 && D > 0.0f;
    const float sqrtD = sqrtf(has2 ? D : 0.0f);
    const float q0 = (-f1 - sqrtD) / (2.0f * qb);
    const float q1 = (-f1 + sqrtD) / (2.0f * qb);

    const float cf3 = is3 ? f3 : 1.0f;
    const float b = f2 / cf3, c = f1 / cf3, d = f0 / cf3;
    const float Q = (b * b - 3.0f * c) / 9.0f;
    const float R = (2.0f * (b * b * b) - 9.0f * b * c + 27.0f * d) / 54.0f;
    const bool three = is3 && (R * R < Q * Q * Q);
    const float sqrtQ = sqrtf(three ? Q : 1.0f);
    const float arg = fminf(fmaxf(R / (sqrtQ * sqrtQ * sqrtQ), -1.0f + 1e-10f), 1.0f - 1e-10f);
    const float theta = acosf(arg);
    const float pi = 3.14159265358979323846f;
    const float th = j == 0 ? theta : (j == 1 ? theta - 2.0f * pi : theta + 2.0f * pi);
    const float t_c = -2.0f * sqrtQ * cosf(th / 3.0f) - b / 3.0f;

    float x;
    if (j == 0) {  // three real roots, one (Cardano), a quadratic's or a line's
        const bool one = is3 && !three;
        const float disc = one ? R * R - Q * Q * Q : 1.0f;
        const float sgn = R > 0.0f ? 1.0f : (R < 0.0f ? -1.0f : 0.0f);
        const float A = -sgn * powf(fabsf(R) + sqrtf(fmaxf(disc, 1e-8f)), 1.0f / 3.0f);
        const float Bv = A == 0.0f ? 0.0f : Q / A;
        const float t_s = A + Bv - b / 3.0f;
        x = three ? t_c : one ? t_s : has2 ? fminf(q0, q1) : is1 ? t_lin : 0.0f;
        has = three || one || has2 || is1;
    } else if (j == 1) {
        x = three ? t_c : has2 ? fmaxf(q0, q1) : 0.0f;
        has = three || has2;
    } else {
        x = three ? t_c : 0.0f;
        has = three;
    }
    for (int it = 0; it < 2; ++it) {
        const float ft = ((f3 * x + f2) * x + f1) * x + f0;
        const float fp = (3.0f * f3 * x + 2.0f * f2) * x + f1;
        const float step = fabsf(fp) > 1e-6f ? ft / fp : 0.0f;
        x = x - fminf(fmaxf(step, -0.5f), 0.5f);
    }
    has = has && fabsf(x) < 1e4f;
    return has ? x : -1.0f;
}

// ops/cubic.py:_cubic_roots_raw; slots without a root hold -1, has[j] says
// which slots hold one
HD void cubic_roots(float f0, float f1, float f2, float f3, float r[3], bool has[3]) {
    for (int j = 0; j < 3; ++j) r[j] = cubic_root(f0, f1, f2, f3, j, has[j]);
}

// render/surface.py:trilerp_field_grad_T
HD void field_grad(const float s[8], float x, float y, float z, float g[3]) {
    const float c00 = s[0] * (1.0f - z) + s[1] * z;
    const float c01 = s[2] * (1.0f - z) + s[3] * z;
    const float c10 = s[4] * (1.0f - z) + s[5] * z;
    const float c11 = s[6] * (1.0f - z) + s[7] * z;
    const float c0 = c00 * (1.0f - y) + c01 * y;
    const float c1 = c10 * (1.0f - y) + c11 * y;
    g[0] = c1 - c0;
    g[1] = x * (c11 - c10) + (1.0f - x) * (c01 - c00);
    g[2] = x * (y * (s[7] - s[6]) + (1.0f - y) * (s[5] - s[4])) +
           (1.0f - x) * (y * (s[3] - s[2]) + (1.0f - y) * (s[1] - s[0]));
}

HD float dot3(const float a[3], const float b[3]) {
    float acc = a[0] * b[0];
    acc = acc + a[1] * b[1];
    return acc + a[2] * b[2];
}

// -g / |g|, with |g|^2 floored at 1e-20
HD void unit_normal(const float g[3], float n[3]) {
    const float nsq = dot3(g, g);
    const float den = sqrtf(nsq > 1e-20f ? nsq : 1e-20f);
    for (int k = 0; k < 3; ++k) n[k] = -g[k] / den;
}

// the 8 corner rows of one voxel: raw alpha, surface (the UDF types'
// softplus of the row's value), and the SH colour contracted with the
// ray's basis while each row streams in
struct Corners {
    float alpha8[8], surf8[8], crgb[3][8];
    bool vox_ok;  // all 8 corners present and (but for UDF_ALPHA) some raw alpha >= sigma_thresh
};

// the link of corner c of voxel l (clamped to the grid)
HD int corner_link(const int* links, int X, int Y, int Z, const int l[3], int c) {
    const int cx = clampi(l[0] + corner_dx(c), 0, X - 1);
    const int cy = clampi(l[1] + corner_dy(c), 0, Y - 1);
    const int cz = clampi(l[2] + corner_dz(c), 0, Z - 1);
    return links[((int64_t)cx * Y + cy) * Z + cz];
}

// One corner row as K3 and K5b read it (gather_corners_lanes), x(j) its
// element j (0 for an absent corner): raw alpha, raw surface value, PLANE's
// plane a, b, c, d (elements 1-4; q may be null), and the colour contracted
// with the ray's basis shm in basis order from element sh_base on. kBd > 0
// fixes the basis_dim and kShBase the colour's first element at compile
// time, so that x may index registers.
template <int kBd = 0, int kShBase = 0, class Elem>
HD void corner_row(Elem x, int sh_base, int bd, const float* shm, float& a, float& sr,
                   float* q, float acc[3]) {
    const int nb = kBd > 0 ? kBd : bd;
    const int base = kBd > 0 ? kShBase : sh_base;
    a = x(0);
    sr = x(1);
    if (q)
        for (int k = 0; k < 4; ++k) q[k] = x(1 + k);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        float v = x(base + ch * nb) * shm[0];
#pragma unroll
        for (int b = 1; b < nb; ++b) v = v + x(base + ch * nb + b) * shm[b];
        acc[ch] = v;
    }
}

// PLANE: the mean of the 8 corners' planes (a, b, c, d), summed in corner
// order (surface.py:592): plane_add for corners 0..7, then plane_mean
HD void plane_add(float pl[4], const float q[4], int c) {
    for (int k = 0; k < 4; ++k) pl[k] = c == 0 ? q[k] : pl[k] + q[k];
}

HD void plane_mean(float pl[4]) {
    for (int k = 0; k < 4; ++k) pl[k] = pl[k] / 8.0f;
}

HD bool voxel_ok(bool all_present, const float alpha8[8], float sigma_thresh, int stype) {
    bool any_alpha = false;
    for (int c = 0; c < 8; ++c) any_alpha = any_alpha || alpha8[c] >= sigma_thresh;
    return all_present && (any_alpha || stype == SURF_UDF_ALPHA);
}

// the plane's one root (surface.py:593-603): d clamped to +-0.3 about the
// voxel centre, the ray-plane t in global grid coordinates
struct PlaneRoot {
    float abc[3], xyz, lo, hi, m, dpl, den_raw, den, N, t_pl;
};

HD void plane_root(const float pl[4], const float o[3], const float d[3], const int l[3],
                   PlaneRoot& q) {
    for (int k = 0; k < 3; ++k) q.abc[k] = pl[k];
    float xyz = ((float)l[0] + 0.5f) * pl[0];
    xyz = xyz + ((float)l[1] + 0.5f) * pl[1];
    q.xyz = xyz + ((float)l[2] + 0.5f) * pl[2];
    q.lo = -0.3f - q.xyz;
    q.hi = 0.3f - q.xyz;
    q.m = fmaxf(pl[3], q.lo);
    q.dpl = fminf(q.m, q.hi);
    q.den_raw = dot3(q.abc, d);
    q.den = fabsf(q.den_raw) < 1e-12f ? 1e-12f : q.den_raw;
    q.N = dot3(q.abc, o) + q.dpl;
    q.t_pl = -q.N / q.den;
}

// one real-root slot: root -> t -> position in the voxel -> alpha, colour,
// normal (surface.py:626-670)
struct RealSlot {
    float t;
    float frac[3];  // o + t d - l, before the clip
    float fs[3];    // the clipped position the sample is taken at
    float w8[8];
    float raw;
    float pre_rgb[3];  // colour before max(., 0)
    float sn[3];
    bool geo_pre;  // geo_ok before the outward-only filter
    bool geo_ok;
};

// plane_n: PLANE's normal (a, b, c), whose root counts from -1e-6; null for
// the scalar fields, whose normal is the field's gradient and whose root
// counts above 0
HD void real_slot(const Corners& cs, const float o[3], const float d[3], const int l[3],
                  float close_t, float root, bool lv_ok, float near_grid_t, int only_outward,
                  const float* plane_n, RealSlot& s) {
    s.t = close_t + root;
    bool in_cube = true;
    for (int a = 0; a < 3; ++a) {
        s.frac[a] = o[a] + s.t * d[a] - (float)l[a];
        in_cube = in_cube && s.frac[a] >= 0.0f && s.frac[a] <= 1.0f;
    }
    const bool root_pos = plane_n ? root > -1e-6f : root > 0.0f;
    s.geo_pre = lv_ok && root_pos && in_cube && s.t >= near_grid_t;
    for (int a = 0; a < 3; ++a) s.fs[a] = fminf(fmaxf(s.geo_pre ? s.frac[a] : 0.5f, 0.0f), 1.0f);
    float g[3];
    if (plane_n)
        for (int a = 0; a < 3; ++a) g[a] = plane_n[a];
    else
        field_grad(cs.surf8, s.fs[0], s.fs[1], s.fs[2], g);
    s.geo_ok = s.geo_pre && (!only_outward || dot3(g, d) > 0.0f);
    unit_normal(g, s.sn);
    trilerp_weights(s.fs[0], s.fs[1], s.fs[2], s.w8);
    s.raw = corner_dot(s.w8, cs.alpha8);
    for (int ch = 0; ch < 3; ++ch) s.pre_rgb[ch] = corner_dot(s.w8, cs.crgb[ch]) + 0.5f;
}

// the fake sample at mid-segment with its Gaussian reweight
// (surf_trav.cu:423-541; surface.py:672-717)
struct FakeSlot {
    float tf;
    float ff[3];
    float fw8[8];
    float fraw;
    float pre_rgb[3];
    float mu, var, std_;
    float s_norm, fake_dist, q;
    float base, gauss, falpha;
    float fsn[3];
    int amin;  // the nearest level set
    bool take;
};

HD void fake_slot(const Corners& cs, const float o[3], const float d[3], const int l[3],
                  float close_t, float far_t, bool vox_has_sample, bool vox_has_surf,
                  float min_vox_len, int limited_fake, int normalize_surf, const float* level_sets,
                  int n_lv, float sigma_thresh, float fs_std, int act_sigmoid,
                  const float* lv_alpha, FakeSlot& f) {
    bool take = cs.vox_ok && !vox_has_sample && (far_t - close_t) > min_vox_len;
    if (limited_fake) take = take && vox_has_surf;
    f.tf = 0.5f * (close_t + far_t);
    for (int a = 0; a < 3; ++a)
        f.ff[a] = fminf(fmaxf(take ? o[a] + f.tf * d[a] - (float)l[a] : 0.5f, 0.0f), 1.0f);
    trilerp_weights(f.ff[0], f.ff[1], f.ff[2], f.fw8);
    f.fraw = corner_dot(f.fw8, cs.alpha8);
    for (int ch = 0; ch < 3; ++ch) f.pre_rgb[ch] = corner_dot(f.fw8, cs.crgb[ch]) + 0.5f;
    float mu = cs.surf8[0];
    for (int c = 1; c < 8; ++c) mu = mu + cs.surf8[c];
    f.mu = mu / 8.0f;
    float var = (cs.surf8[0] - f.mu) * (cs.surf8[0] - f.mu);
    for (int c = 1; c < 8; ++c) var = var + (cs.surf8[c] - f.mu) * (cs.surf8[c] - f.mu);
    f.var = var / 8.0f;
    f.std_ = normalize_surf ? sqrtf(fmaxf(f.var, 1e-9f)) : 1.0f;
    float sn8[8];
    for (int c = 0; c < 8; ++c) sn8[c] = cs.surf8[c] / f.std_;
    f.s_norm = corner_dot(f.fw8, sn8);
    // signed distance to the nearest level set (first on ties)
    f.fake_dist = f.s_norm - level_sets[0];
    f.amin = 0;
    for (int i = 1; i < n_lv; ++i) {
        const float di = f.s_norm - level_sets[i];
        if (fabsf(di) < fabsf(f.fake_dist)) {
            f.fake_dist = di;
            f.amin = i;
        }
    }
    if (lv_alpha) f.fraw = lv_alpha[f.amin];  // UDF_ALPHA: the nearest level set's alpha
    f.take = take && f.fraw > sigma_thresh;
    f.q = f.fake_dist / fs_std;
    f.base = alpha_act(f.fraw, act_sigmoid);
    f.gauss = expf(-0.5f * (f.q * f.q));
    f.falpha = f.base * f.gauss;
    float g[3];
    field_grad(cs.surf8, f.ff[0], f.ff[1], f.ff[2], g);
    unit_normal(g, f.fsn);
}

// the inward-norm and density-lap terms of one slot (surface.py:737-753)
HD float inward_sq(const float sn_in[3], const float d[3]) {
    const float in_pos = fmaxf(dot3(sn_in, d), 0.0f);
    return in_pos * in_pos;
}

HD float lap_term(float alpha) {
    const float p_lap = expf(-alpha) + expf(-(1.0f - alpha));
    return -logf(p_lap);
}

// VOXEL_FACE's one sample at the entry (surface.py:556-588)
struct FaceSlot {
    float ef[3], ew8[8], pre_rgb[3], alpha;
    bool contrib;
};

HD void face_slot(const Corners& cs, const float o[3], const float d[3], const int l[3],
                  float close_t, float near_grid_t, int X, int Y, int Z, FaceSlot& f) {
    const float gsz[3] = {(float)X, (float)Y, (float)Z};
    bool inside = true;
    for (int a = 0; a < 3; ++a) {
        const float e = o[a] + close_t * d[a];
        inside = inside && e >= 1e-6f && e <= gsz[a] - 1.0f - 1e-6f;
        f.ef[a] = fminf(fmaxf(cs.vox_ok ? e - (float)l[a] : 0.5f, 0.0f), 1.0f);
    }
    trilerp_weights(f.ef[0], f.ef[1], f.ef[2], f.ew8);
    for (int ch = 0; ch < 3; ++ch) f.pre_rgb[ch] = corner_dot(f.ew8, cs.crgb[ch]) + 0.5f;
    f.alpha = sigmoid_f(cs.alpha8[0]);
    f.contrib = cs.vox_ok && inside && close_t >= near_grid_t;
}

// the UDF types' per-voxel variance term (surface.py:754-770): the factor
// max(n_lv_in_hull - 1, 0), and the unbiased variance of the 8 corners
HD float udf_var(const float s8[8], float& mu) {
    float acc = s8[0];
    for (int c = 1; c < 8; ++c) acc = acc + s8[c];
    mu = acc / 8.0f;
    float v = (s8[0] - mu) * (s8[0] - mu);
    for (int c = 1; c < 8; ++c) v = v + (s8[c] - mu) * (s8[c] - mu);
    return v / 7.0f;
}

HD float udf_hull_factor(int stype, int n_lv_hull, int n_lv, int fake_sample, int limited_fake) {
    float n = (float)n_lv_hull;
    if (fake_sample && !limited_fake)
        n = (float)n_lv;
    else if (stype == SURF_UDF_FAKE_SAMPLE)
        n = fmaxf(n, 1.0f);
    return fmaxf(n - 1.0f, 0.0f);
}

HD float lap_grad(float alpha) {
    const float e0 = expf(-alpha), e1 = expf(-(1.0f - alpha));
    return (e0 - e1) / (e0 + e1);
}

#ifdef __CUDACC__
constexpr int kK3Lanes = 4;  // lanes an entry in K3 and K5b

// The 8 corner rows of the group's voxel l, each by corner_row (the same
// values in the same order of operations in every kernel that calls it,
// so the same bits): lane lg reads corners lg and lg + 4; every lane of
// the warp calls it and every lane of the group returns all 8 corners,
// with PLANE's mean plane in pl. kBd > 0: rows of basis_dim kBd in 16-byte
// loads, laid out at compile time (every element a register); kBd = 0: any
// basis_dim, element by element. P is K3's or K5b's parameter struct (its
// links, X, Y, Z, packed, C8, n_surf_c, bd and sigma_thresh). own_link and
// own_sraw, when given, receive the links and raw surface values of the
// lane's own two corners.
template <int kType, int kBd, class P>
__device__ __forceinline__ void gather_corners_lanes(const P& p, const float* shm, const int l[3],
                                                     int lane, Corners& cs, float pl[4],
                                                     int* own_link = nullptr,
                                                     float* own_sraw = nullptr) {
    constexpr int G = kK3Lanes, kPer = 8 / G;
    constexpr int kShBase = 1 + (kType == SURF_PLANE ? 4 : 1);
    const int lg = lane & (G - 1);
    float shm_r[kBd > 0 ? kBd : 1];
#pragma unroll
    for (int b = 0; b < (kBd > 0 ? kBd : 1); ++b) shm_r[b] = kBd > 0 ? shm[b] : 0.0f;
    float a_own[kPer], s_own[kPer], c_own[3][kPer], pl_own[4][kPer];
    bool own_ok = true;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int link = corner_link(p.links, p.X, p.Y, p.Z, l, lg + k * G);
        const bool present = link >= 0;
        own_ok = own_ok && present;
        if (own_link) own_link[k] = link;
        float a, sr, q[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc[3];
        float* qp = kType == SURF_PLANE ? q : nullptr;
        if constexpr (kBd > 0) {
            constexpr int kN4 = (kShBase + 3 * kBd + 3) / 4;
            const float4* row =
                reinterpret_cast<const float4*>(p.packed) + (int64_t)(present ? link : 0) * (p.C8 / 4);
            float x[4 * kN4];
#pragma unroll
            for (int qi = 0; qi < kN4; ++qi) {
                const float4 v4 = present ? __ldg(row + qi) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                x[4 * qi] = v4.x;
                x[4 * qi + 1] = v4.y;
                x[4 * qi + 2] = v4.z;
                x[4 * qi + 3] = v4.w;
            }
            corner_row<kBd, kShBase>([&](int j) { return x[j]; }, kShBase, kBd, shm_r, a, sr, qp,
                                     acc);
        } else {
            const float* row = p.packed + (int64_t)(present ? link : 0) * p.C8;
            corner_row([&](int j) { return present ? __ldg(row + j) : 0.0f; }, 1 + p.n_surf_c,
                       p.bd, shm, a, sr, qp, acc);
        }
        if (own_sraw) own_sraw[k] = sr;
        a_own[k] = a;
        s_own[k] = is_udf(kType) ? softplus_f(sr) : sr;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c_own[ch][k] = acc[ch];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pl_own[kk][k] = q[kk];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int src = c % G, k = c / G;
        cs.alpha8[c] = __shfl_sync(kFullWarp, a_own[k], src, G);
        cs.surf8[c] = __shfl_sync(kFullWarp, s_own[k], src, G);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) cs.crgb[ch][c] = __shfl_sync(kFullWarp, c_own[ch][k], src, G);
        if (kType == SURF_PLANE) {
            float q[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) q[kk] = __shfl_sync(kFullWarp, pl_own[kk][k], src, G);
            plane_add(pl, q, c);
        }
    }
    if (kType == SURF_PLANE) plane_mean(pl);
    const bool all = segment_bits<G>(__ballot_sync(kFullWarp, own_ok), lane) == (1u << G) - 1u;
    cs.vox_ok = voxel_ok(all, cs.alpha8, p.sigma_thresh, kType);
}
#endif
