// K13: the MSI background, forward and backward.
//
// Replaces the JAX package's render/background.py:render_background (32)
// and its jax.grad (svox2's surf_trav.cu:2914-3139 and its backward):
// nlayers concentric equirect spheres, (2R, R) links into (n, nlayers, 4)
// rgba rows, walked n_steps = int(nlayers / step_size) + 2 times a ray from
// the ray's inner radius outwards. The background's contribution is linear
// in the foreground's transmittance, so K13 renders it from log_T = 0:
// per ray c_bg = sum_i w_i col_i + exp(log_T_bg) * brightness (B, 3) and
// log_T_bg = sum_i log_att_i (B); the compositors (K4, K8, K10) take c_bg
// where they took the scalar brightness.
//
// background_forward: one thread a ray, JAX's arithmetic in its order
// (float32, --fmad=false): the sphere intersection at each radius, the
// midpoint's equirect (u, v) and layer, the int32 truncation and clamps,
// the wrap of u and v, the layer clamped to nlayers - 1 (JAX's gather
// clamps it at nlayers == 1), the 8 corner rows read as float4, zero where
// a link is -1.
//
// background_backward: one thread a ray, a reverse walk. A step is active
// from the first radius that meets the ray beyond its inner radius on (the
// intersection's discriminant and the radius both grow with the step), so
// the walk stops at the first inactive step and the previous step's exit
// is t of step i - 1, or t_last for the first active one. The transmittance
// before a step is exp(log_T_bg minus the later steps' log_att), and the
// suffix S (the cotangent of log_att_i through every later weight and the
// brightness term) is a running sum, as in K8's backward. Each active step
// adds its 8 corners x 4 channels into the dense gradient with atomics.
//
// Bound: both walks are latency-bound: 8 dependent float4 gathers a step
// from rows scattered over the whole array (2.15 GB for 64 layers at
// reso 1024), and the backward's atomics into as many bytes. Design: one
// thread a ray and nothing shared; no tuning yet.
#include "common.cuh"

struct BgParams {
    const float* origins;      // (B, 3) grid coordinates
    const float* dirs;         // (B, 3) unit, grid coordinates
    const float* delta_scale;  // (B,) grid -> world step
    int B;
    float gx, gy, gz;          // grid size
    const int* links;          // (2R, R)
    int R;
    const float* data;         // (n, nlayers, 4)
    int n_rows;
    int nlayers;
    int n_steps;
    float brightness;
    float* c_bg;               // (B, 3)
    float* log_T;              // (B,): written by the forward, read by the backward
    const float* g_c;          // (B, 3)
    const float* g_lt;         // (B,)
    float* g_data;             // (n, nlayers, 4)
};

struct SphereRay {
    float ox, oy, oz, dx, dy, dz, wss, q2a, qb, fdet, inner, tlast;
};

HD void sphere_ray(const BgParams& p, int r, SphereRay& s) {
    const float sx = 2.0f / p.gx, sy = 2.0f / p.gy, sz = 2.0f / p.gz;
    s.ox = (p.origins[3 * r] + 0.5f) * sx - 1.0f;
    s.oy = (p.origins[3 * r + 1] + 0.5f) * sy - 1.0f;
    s.oz = (p.origins[3 * r + 2] + 0.5f) * sz - 1.0f;
    float dx = p.dirs[3 * r] * sx, dy = p.dirs[3 * r + 1] * sy, dz = p.dirs[3 * r + 2] * sz;
    const float inorm = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    s.wss = p.delta_scale[r] * inorm;
    s.dx = dx * inorm;
    s.dy = dy * inorm;
    s.dz = dz * inorm;
    s.q2a = 2.0f * (s.dx * s.dx + s.dy * s.dy + s.dz * s.dz);
    s.qb = 2.0f * (s.ox * s.dx + s.oy * s.dy + s.oz * s.dz);
    s.fdet = s.qb * s.qb - 2.0f * s.q2a * (s.ox * s.ox + s.oy * s.oy + s.oz * s.oz);
    const float cx = s.oy * s.dz - s.oz * s.dy, cy = s.oz * s.dx - s.ox * s.dz,
                cz = s.ox * s.dy - s.oy * s.dx;
    s.inner = fmaxf(sqrtf(cx * cx + cy * cy + cz * cz) + 1e-3f, 1.0f);
    const float det = s.fdet + 2.0f * s.q2a * s.inner * s.inner;
    s.tlast = det >= 0.0f ? (-s.qb + sqrtf(fmaxf(det, 0.0f))) / s.q2a : 0.0f;
}

// the step's radius meets the ray (beyond its inner radius: active) at t
HD bool sphere_t(const BgParams& p, const SphereRay& s, int i, float& t) {
    const double rd = (double)p.n_steps / ((double)(p.n_steps - i) - 0.5);
    const float det = s.fdet + 2.0f * s.q2a * (float)(rd * rd);
    const bool ok = det >= 0.0f;
    t = ok ? (-s.qb + sqrtf(fmaxf(det, 0.0f))) / s.q2a : 0.0f;
    return ok && (float)rd >= s.inner;
}

struct F4 {
    float v[4];
};

HD F4 load_row(const BgParams& p, int lnk, int layer) {
    F4 out;
    if (lnk < 0) {
        for (int k = 0; k < 4; ++k) out.v[k] = 0.0f;
        return out;
    }
    const float* q = p.data + ((int64_t)lnk * p.nlayers + layer) * 4;
#ifdef __CUDA_ARCH__
    const float4 f = __ldg(reinterpret_cast<const float4*>(q));
    out.v[0] = f.x;
    out.v[1] = f.y;
    out.v[2] = f.z;
    out.v[3] = f.w;
#else
    for (int k = 0; k < 4; ++k) out.v[k] = q[k];
#endif
    return out;
}

// One step's sample: the 8 corners (links and layers, JAX's v000..v111
// order), their weights' factors and the interpolated rgba.
struct BgSample {
    int lnk[8], lay[8];
    float wa[3], wb[3];
    float rgba[4];
};

HD void bg_sample(const BgParams& p, const SphereRay& s, float t, float tl, BgSample& q) {
    const float t_mid = 0.5f * (t + tl);
    float px = s.ox + t_mid * s.dx, py = s.oy + t_mid * s.dy, pz = s.oz + t_mid * s.dz;
    const float invr = 1.0f / sqrtf(px * px + py * py + pz * pz);
    px = px * invr;
    py = py * invr;
    pz = pz * invr;
    const float lat = asinf(fminf(fmaxf(py, -1.0f), 1.0f));
    const float lon = atan2f(px, pz);
    const float pts[3] = {
        (float)(p.R * 2) * (0.5f + lon / 6.2831855f),  // 2 pi in float32
        (float)p.R * (0.5f - lat / 3.1415927f),
        fminf(fmaxf((1.0f - invr) * (float)p.nlayers - 0.5f, 0.0f), (float)(p.nlayers - 1)),
    };
    const int lx = clampi((int)pts[0], 0, 2 * p.R - 1);
    const int ly = clampi((int)pts[1], 0, p.R - 1);
    const int lz = clampi((int)pts[2], 0, p.nlayers - 2 > 0 ? p.nlayers - 2 : 0);
    const int l3[3] = {lx, ly, lz};
    for (int a = 0; a < 3; ++a) {
        q.wb[a] = pts[a] - (float)l3[a];
        q.wa[a] = 1.0f - q.wb[a];
    }
    const int lnx = (lx + 1) % (2 * p.R), lny = (ly + 1) % p.R;
    const int lnz = lz + 1 < p.nlayers - 1 ? lz + 1 : p.nlayers - 1;
    const int xs[2] = {lx, lnx}, ys[2] = {ly, lny}, zs[2] = {lz, lnz};
    F4 v[8];
    for (int c = 0; c < 8; ++c) {
        q.lnk[c] = p.links[(int64_t)xs[corner_dx(c)] * p.R + ys[corner_dy(c)]];
        q.lay[c] = zs[corner_dz(c)];
        v[c] = load_row(p, q.lnk[c], q.lay[c]);
    }
    for (int k = 0; k < 4; ++k) {
        const float c00 = v[0].v[k] * q.wa[2] + v[1].v[k] * q.wb[2];
        const float c01 = v[2].v[k] * q.wa[2] + v[3].v[k] * q.wb[2];
        const float c10 = v[4].v[k] * q.wa[2] + v[5].v[k] * q.wb[2];
        const float c11 = v[6].v[k] * q.wa[2] + v[7].v[k] * q.wb[2];
        const float c0 = c00 * q.wa[1] + c01 * q.wb[1];
        const float c1 = c10 * q.wa[1] + c11 * q.wb[1];
        q.rgba[k] = c0 * q.wa[0] + c1 * q.wb[0];
    }
}

constexpr float BG_SH_C0 = 0.28209479177387814f;

HD void background_forward_ray(const BgParams& p, int r) {
    SphereRay s;
    sphere_ray(p, r, s);
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    float lt = 0.0f, tl = s.tlast;
    BgSample q;
    for (int i = 0; i < p.n_steps; ++i) {
        float t;
        if (!sphere_t(p, s, i, t)) continue;  // inactive: adds nothing, keeps tl
        bg_sample(p, s, t, tl, q);
        const float la = -s.wss * fmaxf(q.rgba[3], 0.0f) * (t - tl);
        const float w = expf(lt) * (1.0f - expf(la));
        for (int k = 0; k < 3; ++k)
            rgb[k] = rgb[k] + fmaxf(q.rgba[k] * BG_SH_C0 + 0.5f, 0.0f) * w;
        lt = lt + la;
        tl = t;
    }
    const float T = expf(lt);
    for (int k = 0; k < 3; ++k) p.c_bg[3 * r + k] = rgb[k] + T * p.brightness;
    p.log_T[r] = lt;
}

HD void background_backward_ray(const BgParams& p, int r) {
    const float G[3] = {p.g_c[3 * r], p.g_c[3 * r + 1], p.g_c[3 * r + 2]};
    const float g_lt = p.g_lt[r];
    SphereRay s;
    sphere_ray(p, r, s);
    float lt_after = p.log_T[r];
    // d loss / d log_att of every step includes the brightness term's
    float S = expf(lt_after) * p.brightness * (G[0] + G[1] + G[2]);
    BgSample q;
    for (int i = p.n_steps - 1; i >= 0; --i) {
        float t, t_prev = 0.0f;
        if (!sphere_t(p, s, i, t)) break;  // every earlier step is inactive too
        const float tl = (i > 0 && sphere_t(p, s, i - 1, t_prev)) ? t_prev : s.tlast;
        bg_sample(p, s, t, tl, q);
        const float k_sig = -s.wss;
        const float la = k_sig * fmaxf(q.rgba[3], 0.0f) * (t - tl);
        const float lt_before = lt_after - la;
        const float T = expf(lt_before), e = expf(la);
        const float w = T * (1.0f - e);
        float gcol = 0.0f, d_rgba[4];
        for (int k = 0; k < 3; ++k) {
            const float x = q.rgba[k] * BG_SH_C0 + 0.5f;
            gcol = gcol + G[k] * fmaxf(x, 0.0f);
            d_rgba[k] = G[k] * w * clip_lo_grad(x, 0.0f) * BG_SH_C0;
        }
        const float d_la = -T * e * gcol + S + g_lt;
        S = S + w * gcol;
        d_rgba[3] = q.rgba[3] > 0.0f ? d_la * k_sig * (t - tl) : 0.0f;
        for (int c = 0; c < 8; ++c) {
            if (q.lnk[c] < 0) continue;
            const float wc = (corner_dx(c) ? q.wb[0] : q.wa[0]) *
                             (corner_dy(c) ? q.wb[1] : q.wa[1]) *
                             (corner_dz(c) ? q.wb[2] : q.wa[2]);
            float* g = p.g_data + ((int64_t)q.lnk[c] * p.nlayers + q.lay[c]) * 4;
            for (int k = 0; k < 4; ++k)
                if (d_rgba[k] != 0.0f && wc != 0.0f) atomic_add(g + k, d_rgba[k] * wc);
        }
        lt_after = lt_before;
    }
}

#ifdef __CUDACC__
__global__ void background_forward_kernel(BgParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) background_forward_ray(p, r);
}

__global__ void background_backward_kernel(BgParams p) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < p.B) background_backward_ray(p, r);
}

static BgParams bg_params(const float* origins, const float* dirs, const float* delta_scale,
                          int B, float gx, float gy, float gz, const int* links, int R,
                          const float* data, int n_rows, int nlayers, int n_steps,
                          float brightness) {
    BgParams p{};
    p.origins = origins;
    p.dirs = dirs;
    p.delta_scale = delta_scale;
    p.B = B;
    p.gx = gx;
    p.gy = gy;
    p.gz = gz;
    p.links = links;
    p.R = R;
    p.data = data;
    p.n_rows = n_rows;
    p.nlayers = nlayers;
    p.n_steps = n_steps;
    p.brightness = brightness;
    return p;
}

extern "C" cudaError_t background_forward(const float* origins, const float* dirs,
                                          const float* delta_scale, int B, float gx, float gy,
                                          float gz, const int* links, int R, const float* data,
                                          int n_rows, int nlayers, int n_steps,
                                          float brightness, float* c_bg, float* log_T,
                                          void* stream) {
    if (B <= 0) return cudaSuccess;
    BgParams p = bg_params(origins, dirs, delta_scale, B, gx, gy, gz, links, R, data, n_rows,
                           nlayers, n_steps, brightness);
    p.c_bg = c_bg;
    p.log_T = log_T;
    const int block = 128;
    background_forward_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}

extern "C" cudaError_t background_backward(const float* origins, const float* dirs,
                                           const float* delta_scale, int B, float gx, float gy,
                                           float gz, const int* links, int R, const float* data,
                                           int n_rows, int nlayers, int n_steps,
                                           float brightness, const float* log_T,
                                           const float* g_c, const float* g_lt, float* g_data,
                                           void* stream) {
    if (B <= 0) return cudaSuccess;
    BgParams p = bg_params(origins, dirs, delta_scale, B, gx, gy, gz, links, R, data, n_rows,
                           nlayers, n_steps, brightness);
    p.log_T = const_cast<float*>(log_T);
    p.g_c = g_c;
    p.g_lt = g_lt;
    p.g_data = g_data;
    const int block = 128;
    background_backward_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}
#endif
