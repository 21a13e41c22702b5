// K6 and K12a-K12g: the cell regularizers, loss and row gradients in one
// pass.
//
// Replaces the JAX package's losses/reg.py: tv_loss (126-155) and
// surface_tv_loss (158-183) in reg_tv, surface_normal_loss (202-302) in
// reg_normal, alpha_surf_sparsify_loss (305-330) in reg_sparsify, and the
// extended surface terms surface_norm_match_loss (569),
// surface_viscosity_loss (599), surface_sign_change_loss (630) and
// surface_eikonal_loss (791) and lumisphere_tv_loss (734) in reg_ext, and
// background_tv_loss (673) in reg_background_tv, and basis_tv_loss (717) in
// reg_basis_tv, each with its jax.grad, as svox2's
// loss_kernel.cu computed loss and gradient together. With a cell list the
// cells are a sampled window (flat lattice ids, reg.py:sample_present_cells
// or sample_cells). Without one (K6's TV and normal only) the launch covers
// every lattice cell, the dense variants surface_tv_loss_dense (384) and
// surface_normal_loss_dense (428): the latter over the cells whose 3x3x3
// window lies inside the lattice, as its slab formulation does. The
// caller's ``scale`` is 1/n for a window of n cells and 1/links.size for
// every cell.
//
// Each cell reads its links (+x/+y/+z neighbours, or the 3x3x3 window), the
// rows they name, computes the cell's loss and its analytic gradient, and
// adds the gradient into its own and its neighbours' rows with atomicAdd;
// the loss is summed over the block and added with one atomic, in double:
// a float32 sum over millions of cells (every-cell mode) drifts.
//
// A density table shorter than the capacity (UDF_ALPHA's one alpha per
// level set) is read and written at row min(link, rows - 1), as the JAX
// package's fetch_links clips its links (core/grid.py:354); the
// sparsifier then sums the last row's gradient, which every link past the
// table adds to, over the warp before its one atomic.
//
// Bound: bytes. Each cell reads 4 (TV, norm match, sign change), 7
// (viscosity), 8 (eikonal) or 27 (normal) links and as many rows and adds
// as many gradients; at the main path's window (0.01 of 2.47M rows) the
// launch itself sets the time.
//
// Design of K6's TV and normal. Every-cell mode visits the present
// vertices, not the lattice: a thread takes row n of the (rows, 3) row
// coordinates that the Trainer keeps once per topology, and stands for
// the cell there only when the link at those coordinates names row n (an
// unlinked row's coordinates are (0, 0, 0), reg.py:row_coords_of). At 512^3
// that is 2.47M threads instead of 134M, and no thread decodes a flat id.
// An empty cell has zero TV differences and no gradient: it adds the
// constant k_empty = (c1 - c0) sqrt(1e-5) sigmoid(0) (or 1 unweighted),
// which the wrapper adds for all links.size cells in float64 and each
// present vertex takes back. A normal cell gives loss and gradient only
// when all 8 corners of its base cube exist, so it needs a present base
// vertex inside the interior box, and every normal cell stops after reading
// its 27 links when one of those 8 is missing. Rows in raster order (as the
// package's grid constructors number them; not a checkpoint's Morton
// order) are consecutive in z, so a warp's link, row and gradient accesses
// fall on few lines. A window's flat id is int32 and decoded in 32 bits.
// The normal's cost is its arithmetic (IEEE divisions and square roots
// under --fmad=false; 87% of the 128^3 shell's rows have a whole base
// cube) and its atomics (a third of its time), not its reads: handing a
// cell's gradient at z + 1 and z + 2 to the lanes that hold those vertices
// along z-runs (8 atomics a cell instead of 20) gained 1-2%, and reading
// each window plane once per run, shared by shuffles, was 60% slower;
// neither was kept.
//
// The TV of many channels (the 27 SH channels) runs a warp a cell, lane c
// on channel c0 + c, so that its row reads coalesce, and adds each row's
// gradient in float4 atomics over the 16-byte slots the row's elements lie
// in (shuffled from the channels' lanes); a 1-channel TV and the normal
// window keep a thread a cell.
#include "common.cuh"

HD int link_at(const int* links, int X, int Y, int Z, int64_t x, int64_t y, int64_t z) {
    if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) return -1;
    return links[(x * Y + y) * Z + z];
}

HD void decode_cell(int64_t cell, int Y, int Z, int64_t& x, int64_t& y, int64_t& z) {
    z = cell % Z;
    const int64_t xy = cell / Z;
    y = xy % Y;
    x = xy / Y;
}

// K6: the link at (x, y, z), -1 outside the lattice; coordinates in 32 bits
HD int link_xyz(const int* links, int X, int Y, int Z, int x, int y, int z) {
    if ((unsigned)x >= (unsigned)X || (unsigned)y >= (unsigned)Y || (unsigned)z >= (unsigned)Z)
        return -1;
    return links[(int64_t)(x * Y + y) * Z + z];
}

// K6: a window's flat id (int32) decoded in 32 bits
HD void decode_window(int cell, int Y, int Z, int& x, int& y, int& z) {
    const unsigned c = (unsigned)cell, yy = (unsigned)Y, zz = (unsigned)Z;
    const unsigned xy = c / zz;
    z = (int)(c - xy * zz);
    const unsigned xq = xy / yy;
    y = (int)(xy - xq * yy);
    x = (int)xq;
}

// K6's every-cell mode: row n's coordinates, and whether the link there
// names row n (false for a row no link names)
HD bool row_cell(const int* links, const int* row_coords, int X, int Y, int Z, int64_t n, int& x,
                 int& y, int& z) {
    x = row_coords[3 * n];
    y = row_coords[3 * n + 1];
    z = row_coords[3 * n + 2];
    return link_xyz(links, X, Y, Z, x, y, z) == (int)n;
}

// ---------------------------------------------------------------------------
// TV over channels [c0, c1) of a (cap, C) array; optionally each cell
// weighted by sigmoid of its raw alpha (detached), as surface_tv_loss's
// alpha_weighted
// ---------------------------------------------------------------------------

struct TVParams {
    const int* links;
    int X, Y, Z;
    const int* cells;  // (n,) flat ids, or null for every lattice cell
    const int* row_coords;  // (n, 3) coordinates of each row: every-cell mode
    int64_t n;  // cells, or rows
    const float* data;
    int64_t rows;  // rows of data: a link reads row min(link, rows - 1)
    int C, c0, c1;
    const float* wdens;  // (wrows,) raw alpha, or null for no weighting
    int64_t wrows;
    float scale;
    float k_empty;  // every-cell mode: the loss of an empty cell, before scale
    double* loss;  // (1,), float64
    float* grad;  // (cap, C)
};

// the row a link reads in a table of `rows` rows (fetch_links's clip)
HD int64_t row_of(int link, int64_t rows) { return link < rows ? (int64_t)link : rows - 1; }

// the cell's weight: sigmoid of the raw alpha at its link w0 (0 where w0 is
// -1), or 1 unweighted
HD float tv_weight(const TVParams& p, int w0) {
    if (!p.wdens) return 1.0f;
    return 1.0f / (1.0f + expf(-(w0 >= 0 ? p.wdens[row_of(w0, p.wrows)] : 0.0f)));
}

// the TV of the cell at (x, y, z), summed over the channels, its gradient
// (times aw and scale) added into the rows
HD float tv_at(const TVParams& p, int x, int y, int z, float aw) {
    const int64_t l0 = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x, y, z), p.rows);
    const int64_t lx = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x + 1, y, z), p.rows);
    const int64_t ly = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x, y + 1, z), p.rows);
    const int64_t lz = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x, y, z + 1), p.rows);
    float loss = 0.0f;
    for (int ch = p.c0; ch < p.c1; ++ch) {
        const float v0 = l0 >= 0 ? p.data[l0 * p.C + ch] : 0.0f;
        const float vx = lx >= 0 ? p.data[lx * p.C + ch] : 0.0f;
        const float vy = ly >= 0 ? p.data[ly * p.C + ch] : 0.0f;
        const float vz = lz >= 0 ? p.data[lz * p.C + ch] : 0.0f;
        const float dx = (l0 >= 0 && lx >= 0) ? vx - v0 : 0.0f;
        const float dy = (l0 >= 0 && ly >= 0) ? vy - v0 : 0.0f;
        const float dz = (l0 >= 0 && lz >= 0) ? vz - v0 : 0.0f;
        const float sq = sqrtf(1e-5f + dx * dx + dy * dy + dz * dz);
        loss = loss + sq;
        const float g = p.scale * aw / sq;
        if (dx != 0.0f) atomic_add(p.grad + lx * p.C + ch, g * dx);
        if (dy != 0.0f) atomic_add(p.grad + ly * p.C + ch, g * dy);
        if (dz != 0.0f) atomic_add(p.grad + lz * p.C + ch, g * dz);
        const float g0 = -(g * dx + g * dy + g * dz);
        if (g0 != 0.0f) atomic_add(p.grad + l0 * p.C + ch, g0);
    }
    return loss;
}

// window cell n, a thread a cell
HD float tv_cell(const TVParams& p, int64_t n) {
    int x, y, z;
    decode_window(p.cells[n], p.Y, p.Z, x, y, z);
    const float aw = tv_weight(p, link_xyz(p.links, p.X, p.Y, p.Z, x, y, z));
    return tv_at(p, x, y, z, aw) * aw * p.scale;
}

// every-cell mode, row n: its cell's loss less the empty cell's, which the
// wrapper counted for every cell
HD float tv_row(const TVParams& p, int64_t n) {
    int x, y, z;
    if (!row_cell(p.links, p.row_coords, p.X, p.Y, p.Z, n, x, y, z)) return 0.0f;
    const float aw = tv_weight(p, (int)n);
    return (tv_at(p, x, y, z, aw) * aw - p.k_empty) * p.scale;
}

#ifdef __CUDACC__
// v, lane j's value of element e0 + j (j < m <= 32), added to g (n_el
// floats) by float4 atomics in the 16-byte slots elements e0 .. e0 + m - 1
// lie in: slot lane q gathers its 4 elements from their lanes by shuffles,
// an element outside the m adds 0, and a slot past the array's end adds
// element by element. Every lane of the warp calls it.
__device__ __forceinline__ void add_row_slots(float* g, int64_t n_el, int64_t e0, int m, float v,
                                              int lane) {
    const int ph = (int)(e0 & 3);
    float x[4];
    bool any = false;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int j = 4 * lane + t - ph;
        const bool in = j >= 0 && j < m;
        const float w = __shfl_sync(kFullWarp, v, in ? j : 0);
        x[t] = in ? w : 0.0f;
        any = any || x[t] != 0.0f;
    }
    if (lane < ((ph + m + 3) >> 2) && any) {
        const int64_t a = e0 - ph + 4 * lane;
        if (a + 4 <= n_el) {
            atomicAdd(reinterpret_cast<float4*>(g + a), make_float4(x[0], x[1], x[2], x[3]));
        } else {
            for (int t = 0; t < 4; ++t)
                if (x[t] != 0.0f) atomicAdd(g + a + t, x[t]);
        }
    }
}

// window cell n on a warp, lane c on channels c0 + c, c0 + c + 32, ...:
// this lane's share of the loss; the row gradients go out in float4 slots
__device__ __forceinline__ float tv_cell_wide(const TVParams& p, int64_t n, int lane) {
    int x, y, z;
    decode_window(p.cells[n], p.Y, p.Z, x, y, z);
    const int w0 = link_xyz(p.links, p.X, p.Y, p.Z, x, y, z);
    const int64_t l0 = row_of(w0, p.rows);
    const int64_t lx = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x + 1, y, z), p.rows);
    const int64_t ly = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x, y + 1, z), p.rows);
    const int64_t lz = row_of(link_xyz(p.links, p.X, p.Y, p.Z, x, y, z + 1), p.rows);
    const float aw = tv_weight(p, w0);
    const int64_t n_el = p.rows * p.C;
    float loss = 0.0f;
    for (int cb = p.c0; cb < p.c1; cb += 32) {
        const int m = p.c1 - cb < 32 ? p.c1 - cb : 32, ch = cb + lane;
        const bool on = lane < m;
        const float v0 = on && l0 >= 0 ? p.data[l0 * p.C + ch] : 0.0f;
        const float vx = on && lx >= 0 ? p.data[lx * p.C + ch] : 0.0f;
        const float vy = on && ly >= 0 ? p.data[ly * p.C + ch] : 0.0f;
        const float vz = on && lz >= 0 ? p.data[lz * p.C + ch] : 0.0f;
        const float dx = (l0 >= 0 && lx >= 0) ? vx - v0 : 0.0f;
        const float dy = (l0 >= 0 && ly >= 0) ? vy - v0 : 0.0f;
        const float dz = (l0 >= 0 && lz >= 0) ? vz - v0 : 0.0f;
        const float sq = sqrtf(1e-5f + dx * dx + dy * dy + dz * dz);
        if (on) loss = loss + sq;
        const float g = p.scale * aw / sq;
        // the links are the warp's, so every lane takes the same branches
        if (l0 >= 0 && lx >= 0) add_row_slots(p.grad, n_el, lx * p.C + cb, m, g * dx, lane);
        if (l0 >= 0 && ly >= 0) add_row_slots(p.grad, n_el, ly * p.C + cb, m, g * dy, lane);
        if (l0 >= 0 && lz >= 0) add_row_slots(p.grad, n_el, lz * p.C + cb, m, g * dz, lane);
        if (l0 >= 0 && (lx >= 0 || ly >= 0 || lz >= 0))
            add_row_slots(p.grad, n_el, l0 * p.C + cb, m, -(g * dx + g * dy + g * dz), lane);
    }
    return loss * aw * p.scale;
}
#endif

// ---------------------------------------------------------------------------
// normal consistency over the 3x3x3 vertex window of each cell
// ---------------------------------------------------------------------------

struct NormalParams {
    const int* links;
    int X, Y, Z;
    const int* cells;  // (n,) flat ids, or null for every cell of the interior box
    const int* row_coords;  // (n, 3) coordinates of each row: every-cell mode
    int64_t n;  // cells, or rows
    const float* surf;  // (cap, n_surf_c), channel 0
    int n_surf_c;
    const float* level_sets;
    int n_lv;
    int con_check, ignore_empty, use_l1;
    float scale;
    double* loss;  // (1,), float64
    float* grad;  // (cap, n_surf_c)
};

// corner-averaged gradient of the cell at base offset (bx, by, bz) of the
// window (reg.py:_cell_normal)
HD void cell_normal(const float S[3][3][3], int bx, int by, int bz, float n[3]) {
    const int x = bx, y = by, z = bz;
    n[0] = ((S[x + 1][y][z] + S[x + 1][y][z + 1] + S[x + 1][y + 1][z] + S[x + 1][y + 1][z + 1]) -
            (S[x][y][z] + S[x][y][z + 1] + S[x][y + 1][z] + S[x][y + 1][z + 1])) / 4.0f;
    n[1] = ((S[x][y + 1][z] + S[x][y + 1][z + 1] + S[x + 1][y + 1][z] + S[x + 1][y + 1][z + 1]) -
            (S[x][y][z] + S[x][y][z + 1] + S[x + 1][y][z] + S[x + 1][y][z + 1])) / 4.0f;
    n[2] = ((S[x][y][z + 1] + S[x][y + 1][z + 1] + S[x + 1][y][z + 1] + S[x + 1][y + 1][z + 1]) -
            (S[x][y][z] + S[x][y + 1][z] + S[x + 1][y][z] + S[x + 1][y + 1][z])) / 4.0f;
}

// the transpose of cell_normal: add dn into the window's 8 values
HD void cell_normal_vjp(const float dn[3], int x, int y, int z, float G[3][3][3]) {
    for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
            for (int k = 0; k < 2; ++k) {
                const float sx = i ? 0.25f : -0.25f, sy = j ? 0.25f : -0.25f, sz = k ? 0.25f : -0.25f;
                G[x + i][y + j][z + k] =
                    G[x + i][y + j][z + k] + (dn[0] * sx + dn[1] * sy + dn[2] * sz);
            }
}

struct Unit {
    float v[3], N[3], sq, q, m;
};

// v / max(sqrt(sq > 1e-20 ? sq : 1e-20), 1e-10)
HD void unit(const float v[3], Unit& u) {
    for (int k = 0; k < 3; ++k) u.v[k] = v[k];
    u.sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
    u.q = sqrtf(u.sq > 1e-20f ? u.sq : 1e-20f);
    u.m = fmaxf(u.q, 1e-10f);
    for (int k = 0; k < 3; ++k) u.N[k] = v[k] / u.m;
}

HD void unit_vjp(const Unit& u, const float gN[3], float gv[3]) {
    const float vg = u.v[0] * gN[0] + u.v[1] * gN[1] + u.v[2] * gN[2];
    // through the norm: only where sq > 1e-20, halved at the max's tie
    const float through = (u.sq > 1e-20f ? 1.0f : 0.0f) * clip_lo_grad(u.q, 1e-10f);
    const float c = through * vg / (u.q * u.m * u.m);
    for (int k = 0; k < 3; ++k) gv[k] = gN[k] / u.m - u.v[k] * c;
}

HD bool exists(const int L[3][3][3], int x, int y, int z) {
    bool m = true;
    for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
            for (int k = 0; k < 2; ++k) m = m && L[x + i][y + j][z + k] >= 0;
    return m;
}

HD bool empty(const float S[3][3][3], int x, int y, int z) {
    bool le = true, ge = true;
    for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
            for (int k = 0; k < 2; ++k) {
                le = le && S[x + i][y + j][z + k] <= 0.0f;
                ge = ge && S[x + i][y + j][z + k] >= 0.0f;
            }
    return le || ge;
}

HD bool face_con(const NormalParams& p, float a, float b, float c, float d) {
    const float mn = fminf(fminf(a, b), fminf(c, d));
    const float mx = fmaxf(fmaxf(a, b), fmaxf(c, d));
    bool con = false;
    for (int i = 0; i < p.n_lv; ++i) con = con || (p.level_sets[i] >= mn && p.level_sets[i] <= mx);
    return con;
}

// sum of |a - b| (L1) or (a - b)^2 over 3 components, and its derivative
// in a: sign(a - b) (sign(0) = 0) or 2 (a - b)
HD float ndiff(const float a[3], const float b[3], int use_l1, float g[3]) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) {
        const float e = a[k] - b[k];
        acc = acc + (use_l1 ? fabsf(e) : e * e);
        g[k] = use_l1 ? (e > 0.0f ? 1.0f : (e < 0.0f ? -1.0f : 0.0f)) : 2.0f * e;
    }
    return acc;
}

// the normal loss of the cell at (x, y, z), its gradient added: its 27
// links first (independent loads), its values only where the 8 corners of
// its base cube exist (m000), without which a cell gives nothing
HD float normal_at(const NormalParams& p, int x, int y, int z) {
    int L[3][3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            for (int k = 0; k < 3; ++k)
                L[i][j][k] = link_xyz(p.links, p.X, p.Y, p.Z, x + i, y + j, z + k);
    if (!exists(L, 0, 0, 0)) return 0.0f;
    float S[3][3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            for (int k = 0; k < 3; ++k)
                S[i][j][k] = L[i][j][k] >= 0 ? p.surf[(int64_t)L[i][j][k] * p.n_surf_c] : 0.0f;
    const bool m001 = exists(L, 0, 0, 1), m010 = exists(L, 0, 1, 0), m100 = exists(L, 1, 0, 0);
    bool con001 = true, con010 = true, con100 = true;
    if (p.con_check) {
        con001 = face_con(p, S[0][0][1], S[0][1][1], S[1][0][1], S[1][1][1]);
        con010 = face_con(p, S[0][1][0], S[0][1][1], S[1][1][0], S[1][1][1]);
        con100 = face_con(p, S[1][0][0], S[1][0][1], S[1][1][0], S[1][1][1]);
    }
    bool e000 = false, e001 = false, e010 = false, e100 = false;
    if (p.ignore_empty) {
        e000 = empty(S, 0, 0, 0);
        e001 = empty(S, 0, 0, 1);
        e010 = empty(S, 0, 1, 0);
        e100 = empty(S, 1, 0, 0);
    }
    const bool skip_z = !m001 || !con001 || (e000 && e001);
    const bool skip_y = !m010 || !con010 || (e000 && e010);
    const bool skip_x = !m100 || !con100 || (e000 && e100);
    const int count = 3 - (int)skip_z - (int)skip_y - (int)skip_x;
    if (count == 0) return 0.0f;

    float v[3];
    Unit u000, u001, u010, u100;
    cell_normal(S, 0, 0, 0, v);
    unit(v, u000);
    cell_normal(S, 0, 0, 1, v);
    unit(v, u001);
    cell_normal(S, 0, 1, 0, v);
    unit(v, u010);
    cell_normal(S, 1, 0, 0, v);
    unit(v, u100);
    float gz[3], gy[3], gx[3];
    const float dz = skip_z ? 0.0f : ndiff(u001.N, u000.N, p.use_l1, gz);
    const float dy = skip_y ? 0.0f : ndiff(u010.N, u000.N, p.use_l1, gy);
    const float dx = skip_x ? 0.0f : ndiff(u100.N, u000.N, p.use_l1, gx);
    const float cell_loss = (dx + dy + dz) / (float)count;

    // gradient: d per_cell / d N, through unit() and cell_normal() into S
    const float c = p.scale / (float)count;
    float g000[3] = {0.0f, 0.0f, 0.0f}, g001[3] = {0.0f, 0.0f, 0.0f};
    float g010[3] = {0.0f, 0.0f, 0.0f}, g100[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
        if (!skip_z) {
            g001[k] = c * gz[k];
            g000[k] = g000[k] - c * gz[k];
        }
        if (!skip_y) {
            g010[k] = c * gy[k];
            g000[k] = g000[k] - c * gy[k];
        }
        if (!skip_x) {
            g100[k] = c * gx[k];
            g000[k] = g000[k] - c * gx[k];
        }
    }
    float G[3][3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            for (int k = 0; k < 3; ++k) G[i][j][k] = 0.0f;
    float gv[3];
    unit_vjp(u000, g000, gv);
    cell_normal_vjp(gv, 0, 0, 0, G);
    unit_vjp(u001, g001, gv);
    cell_normal_vjp(gv, 0, 0, 1, G);
    unit_vjp(u010, g010, gv);
    cell_normal_vjp(gv, 0, 1, 0, G);
    unit_vjp(u100, g100, gv);
    cell_normal_vjp(gv, 1, 0, 0, G);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            for (int k = 0; k < 3; ++k)
                if (L[i][j][k] >= 0 && G[i][j][k] != 0.0f)
                    atomic_add(p.grad + (int64_t)L[i][j][k] * p.n_surf_c, G[i][j][k]);
    return cell_loss * p.scale;
}

// window cell n
HD float normal_cell(const NormalParams& p, int64_t n) {
    int x, y, z;
    decode_window(p.cells[n], p.Y, p.Z, x, y, z);
    return normal_at(p, x, y, z);
}

// every-cell mode, row n: the cell whose base vertex it is, in the
// interior box
HD float normal_row(const NormalParams& p, int64_t n) {
    int x, y, z;
    if (!row_cell(p.links, p.row_coords, p.X, p.Y, p.Z, n, x, y, z)) return 0.0f;
    if (x > p.X - 3 || y > p.Y - 3 || z > p.Z - 3) return 0.0f;
    return normal_at(p, x, y, z);
}

// ---------------------------------------------------------------------------
// alpha/surface sparsifier
// ---------------------------------------------------------------------------

struct SparsifyParams {
    const int* links;
    int X, Y, Z;
    const int* cells;
    int64_t n;
    const float* density;  // (rows,)
    int64_t rows;
    const float* surf;     // (cap, n_surf_c), channel 0
    int n_surf_c;
    float scale_alpha, scale_surf, surf_sign, surf_thresh, scale;
    double* loss;  // (1,), float64
    float* g_density;
    float* g_surface;
};

// g_last: the cell's gradient of the density table's last row, when the
// table is shorter than the capacity (the caller sums it over the warp)
HD float sparsify_cell(const SparsifyParams& p, int64_t n, float& g_last) {
    int64_t x, y, z;
    decode_cell(p.cells ? (int64_t)p.cells[n] : n, p.Y, p.Z, x, y, z);
    const int l0 = link_at(p.links, p.X, p.Y, p.Z, x, y, z);
    const int64_t r0 = row_of(l0, p.rows);
    const float a = l0 >= 0 ? p.density[r0] : 0.0f;
    const float s = l0 >= 0 ? p.surf[(int64_t)l0 * p.n_surf_c] : 0.0f;
    // log_sigmoid(a) = -softplus(-a); sigmoid(-a) is its derivative
    const float log_sig = -(fmaxf(-a, 0.0f) + log1pf(expf(-fabsf(a))));
    const float sig_neg = 1.0f / (1.0f + expf(a));
    const float w = a < p.surf_thresh ? sig_neg : 0.0f;
    if (l0 >= 0) {
        const float ga = p.scale * p.scale_alpha * sig_neg;
        const float gs = p.scale * p.scale_surf * w * p.surf_sign;
        if (r0 == p.rows - 1)
            g_last = ga;
        else if (ga != 0.0f)
            atomic_add(p.g_density + r0, ga);
        if (gs != 0.0f) atomic_add(p.g_surface + (int64_t)l0 * p.n_surf_c, gs);
    }
    return (p.scale_alpha * log_sig + p.scale_surf * (w * s * p.surf_sign)) * p.scale;
}

// ---------------------------------------------------------------------------
// K12a-K12d: the extended surface regularizers (reg.py:569-809), each over
// a window of cells, each thread a cell: its loss and the analytic gradient
// of the rows it reads. The caller's ``scale`` is 1/n.
// ---------------------------------------------------------------------------

struct ExtParams {
    const int* links;
    int X, Y, Z;
    const int* cells;  // (n,) flat ids
    int64_t n;
    int cap;
    const float* surf;  // (cap, n_surf_c), channel 0
    int n_surf_c;
    const float* density;  // (n_dens,): K12a's second field, read at row_of(link, n_dens)
    int64_t n_dens;
    const float* h;  // (1,) grid spacing on the device: K12b
    float eta;  // K12b
    float target;  // K12d
    float scale;
    double* loss;  // (1,), float64
    float* g_surface;  // (cap, n_surf_c)
    float* g_density;  // (cap,): K12a
    const float* sh;  // (cap, 3 bd): K12e
    int bd;
    const float* mult;  // (2, bd): K12e's SH basis along d and along its twin
    float dir_factor;  // K12e
    float* g_sh;  // (cap, 3 bd): K12e
};

HD float surf_at(const ExtParams& p, int l) { return p.surf[(int64_t)l * p.n_surf_c]; }

HD void add_surf(const ExtParams& p, int l, float g) {
    if (g != 0.0f) atomic_add(p.g_surface + (int64_t)l * p.n_surf_c, g);
}

// K12a. The forward differences of one field to the +x/+y/+z neighbours
// (0 where a neighbour is absent) and their safe unit vector: below
// sq = 1e-16 the denominator is the constant 1e-8 and carries no gradient
// (reg.py:587-590).
struct SafeUnit {
    float g[3], N[3], sq, q, m;
};

HD void safe_unit(const float g[3], SafeUnit& u) {
    for (int k = 0; k < 3; ++k) u.g[k] = g[k];
    u.sq = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
    u.q = sqrtf(u.sq > 1e-16f ? u.sq : 1e-16f);
    u.m = fmaxf(u.q, 1e-8f);
    for (int k = 0; k < 3; ++k) u.N[k] = g[k] / u.m;
}

HD void safe_unit_vjp(const SafeUnit& u, const float gN[3], float gg[3]) {
    const float vg = (u.g[0] * gN[0] + u.g[1] * gN[1]) + u.g[2] * gN[2];
    const float through = (u.sq > 1e-16f ? 1.0f : 0.0f) * clip_lo_grad(u.q, 1e-8f);
    const float c = through * vg / (u.q * u.m * u.m);
    for (int k = 0; k < 3; ++k) gg[k] = gN[k] / u.m - u.g[k] * c;
}

HD float norm_match_cell(const ExtParams& p, int64_t n) {
    int64_t x, y, z;
    decode_cell(p.cells[n], p.Y, p.Z, x, y, z);
    const int l0 = link_at(p.links, p.X, p.Y, p.Z, x, y, z);
    if (l0 < 0) return 0.0f;
    const int ln[3] = {link_at(p.links, p.X, p.Y, p.Z, x + 1, y, z),
                       link_at(p.links, p.X, p.Y, p.Z, x, y + 1, z),
                       link_at(p.links, p.X, p.Y, p.Z, x, y, z + 1)};
    float gs[3], ga[3];
    const float s0 = surf_at(p, l0), a0 = p.density[row_of(l0, p.n_dens)];
    for (int k = 0; k < 3; ++k) {
        gs[k] = ln[k] >= 0 ? surf_at(p, ln[k]) - s0 : 0.0f;
        ga[k] = ln[k] >= 0 ? p.density[row_of(ln[k], p.n_dens)] - a0 : 0.0f;
    }
    SafeUnit us, ua;
    safe_unit(gs, us);
    safe_unit(ga, ua);
    float d[3], gNs[3], gNa[3];
    for (int k = 0; k < 3; ++k) {
        d[k] = us.N[k] - ua.N[k];
        gNs[k] = p.scale * 2.0f * d[k];
        gNa[k] = -gNs[k];
    }
    const float cell_loss = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
    float dgs[3], dga[3];
    safe_unit_vjp(us, gNs, dgs);
    safe_unit_vjp(ua, gNa, dga);
    float c0s = 0.0f, c0a = 0.0f;
    for (int k = 0; k < 3; ++k) {
        if (ln[k] < 0) continue;
        add_surf(p, ln[k], dgs[k]);
        if (dga[k] != 0.0f) atomic_add(p.g_density + row_of(ln[k], p.n_dens), dga[k]);
        c0s = c0s - dgs[k];
        c0a = c0a - dga[k];
    }
    add_surf(p, l0, c0s);
    if (c0a != 0.0f) atomic_add(p.g_density + row_of(l0, p.n_dens), c0a);
    return cell_loss * p.scale;
}

// K12b. Over the cells whose 6 neighbours are present; sign(s0) carries no
// gradient, and sqrt(max(g2, 1e-8)) is constant below the clamp.
HD float viscosity_cell(const ExtParams& p, int64_t n) {
    int64_t x, y, z;
    decode_cell(p.cells[n], p.Y, p.Z, x, y, z);
    const int l[7] = {link_at(p.links, p.X, p.Y, p.Z, x, y, z),
                      link_at(p.links, p.X, p.Y, p.Z, x + 1, y, z),
                      link_at(p.links, p.X, p.Y, p.Z, x - 1, y, z),
                      link_at(p.links, p.X, p.Y, p.Z, x, y + 1, z),
                      link_at(p.links, p.X, p.Y, p.Z, x, y - 1, z),
                      link_at(p.links, p.X, p.Y, p.Z, x, y, z + 1),
                      link_at(p.links, p.X, p.Y, p.Z, x, y, z - 1)};
    for (int k = 0; k < 7; ++k)
        if (l[k] < 0) return 0.0f;
    float s[7];
    for (int k = 0; k < 7; ++k) s[k] = surf_at(p, l[k]);
    const float h = p.h[0], h2 = 2.0f * h, hh = h * h;
    float dc[3];
    for (int a = 0; a < 3; ++a) dc[a] = (s[1 + 2 * a] - s[2 + 2 * a]) / h2;
    const float g2 = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2];
    const float gnorm = sqrtf(fmaxf(g2, 1e-8f));
    const float lap = (s[1] + s[2] + s[3] + s[4] + s[5] + s[6] - 6.0f * s[0]) / hh;
    const float sgn = s[0] > 0.0f ? 1.0f : (s[0] < 0.0f ? -1.0f : 0.0f);
    const float r = (gnorm - 1.0f) * sgn - p.eta * lap;
    // d loss / d r, then through gnorm (d gnorm / d g2 below the clamp is 0,
    // halved at its tie) and the laplacian
    const float gr = p.scale * 2.0f * r;
    const float gg2 = gr * sgn * clip_lo_grad(g2, 1e-8f) / (2.0f * gnorm);
    const float glap = -gr * p.eta / hh;
    for (int a = 0; a < 3; ++a) {
        const float gd = gg2 * 2.0f * dc[a] / h2;
        add_surf(p, l[1 + 2 * a], gd + glap);
        add_surf(p, l[2 + 2 * a], glap - gd);
    }
    add_surf(p, l[0], -6.0f * glap);
    return r * r * p.scale;
}

// K12c. Every link reads row lnk mod cap, so -1 reads the last row; the
// gradient of that row is returned in ``last`` for the caller to reduce.
HD int64_t clip64(int64_t v, int64_t hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// the row of the link at clipped coordinates, mod cap
HD int wrap_row_at(const ExtParams& p, int64_t x, int64_t y, int64_t z) {
    const int l = p.links[(clip64(x, p.X - 1) * p.Y + clip64(y, p.Y - 1)) * p.Z +
                          clip64(z, p.Z - 1)];
    return l < 0 ? l % p.cap + p.cap : l % p.cap;
}

HD float sign_change_cell(const ExtParams& p, int64_t n, float& last) {
    last = 0.0f;
    int64_t x, y, z;
    decode_cell(p.cells[n], p.Y, p.Z, x, y, z);
    const int r0 = wrap_row_at(p, x, y, z);
    const float s0 = surf_at(p, r0);
    const int rn[3] = {wrap_row_at(p, x + 1, y, z), wrap_row_at(p, x, y + 1, z),
                       wrap_row_at(p, x, y, z + 1)};
    const bool inb[3] = {x + 1 < p.X, y + 1 < p.Y, z + 1 < p.Z};
    const float rs[3] = {(float)p.X / 256.0f, (float)p.Y / 256.0f, (float)p.Z / 256.0f};
    float total = 0.0f, count = 0.0f;
    bool hit[3];
    for (int a = 0; a < 3; ++a) {
        const float sn = inb[a] ? surf_at(p, rn[a]) : s0;
        hit[a] = inb[a] && s0 * sn < 0.0f;
        if (hit[a]) {
            total = total + (s0 + sn) * rs[a];
            count = count + 1.0f;
        }
    }
    if (count == 0.0f) return 0.0f;
    const float c = p.scale / count;
    float g0 = 0.0f;
    for (int a = 0; a < 3; ++a) {
        if (!hit[a]) continue;
        const float g = c * rs[a];
        g0 = g0 + g;
        if (rn[a] == p.cap - 1)
            last = last + g;
        else
            add_surf(p, rn[a], g);
    }
    if (r0 == p.cap - 1)
        last = last + g0;
    else
        add_surf(p, r0, g0);
    return total / count * p.scale;
}

// K12d. Over the cells whose 8 corners are present: g the mean of the 4
// edge differences along each axis.
HD float eikonal_cell(const ExtParams& p, int64_t n) {
    int64_t x, y, z;
    decode_cell(p.cells[n], p.Y, p.Z, x, y, z);
    int l[8];
    float s[8];
    for (int c = 0; c < 8; ++c) {
        l[c] = link_at(p.links, p.X, p.Y, p.Z, x + corner_dx(c), y + corner_dy(c),
                       z + corner_dz(c));
        if (l[c] < 0) return 0.0f;
        s[c] = surf_at(p, l[c]);
    }
    // corners in reference order (z fastest): c = 4 dx + 2 dy + dz
    const float dx = ((s[4] - s[0]) + (s[5] - s[1]) + (s[6] - s[2]) + (s[7] - s[3])) / 4.0f;
    const float dy = ((s[2] - s[0]) + (s[3] - s[1]) + (s[6] - s[4]) + (s[7] - s[5])) / 4.0f;
    const float dz = ((s[1] - s[0]) + (s[3] - s[2]) + (s[5] - s[4]) + (s[7] - s[6])) / 4.0f;
    const float gnorm = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    const float e = gnorm - p.target;
    const float c = p.scale * 2.0f * e / gnorm / 4.0f;
    const float gx = c * dx, gy = c * dy, gz = c * dz;
    for (int k = 0; k < 8; ++k) {
        const float g = (corner_dx(k) ? gx : -gx) + (corner_dy(k) ? gy : -gy) +
                        (corner_dz(k) ? gz : -gz);
        add_surf(p, l[k], g);
    }
    return e * e * p.scale;
}

// K12e. The cell's SH colour along d against its +x/+y/+z neighbours'
// (both links present) and against its own colour along d's twin, each
// sqrt(1e-5 + |difference|^2).
HD void sh_color(const ExtParams& p, int l, const float* mult, float c[3]) {
    const float* row = p.sh + (int64_t)l * 3 * p.bd;
    for (int ch = 0; ch < 3; ++ch) {
        float acc = row[ch * p.bd] * mult[0];
        for (int b = 1; b < p.bd; ++b) acc = acc + row[ch * p.bd + b] * mult[b];
        c[ch] = acc;
    }
}

HD void add_sh(const ExtParams& p, int l, const float g[3], const float* mult) {
    float* row = p.g_sh + (int64_t)l * 3 * p.bd;
    for (int ch = 0; ch < 3; ++ch) {
        if (g[ch] == 0.0f) continue;
        for (int b = 0; b < p.bd; ++b) atomic_add(row + ch * p.bd + b, g[ch] * mult[b]);
    }
}

// the term sqrt(1e-5 + |a - c0|^2) and its gradient ga (= -gradient of c0),
// times s
HD float color_tv(const float a[3], const float c0[3], float s, float ga[3]) {
    float d[3], sq = 1e-5f;
    for (int ch = 0; ch < 3; ++ch) {
        d[ch] = a[ch] - c0[ch];
        sq = sq + d[ch] * d[ch];
    }
    const float f = sqrtf(sq);
    for (int ch = 0; ch < 3; ++ch) ga[ch] = s * d[ch] / f;
    return f;
}

HD float lumisphere_cell(const ExtParams& p, int64_t n) {
    int64_t x, y, z;
    decode_cell(p.cells[n], p.Y, p.Z, x, y, z);
    const int l0 = link_at(p.links, p.X, p.Y, p.Z, x, y, z);
    if (l0 < 0) return 0.0f;
    const float* m0 = p.mult;
    float c0[3], g0[3] = {0.0f, 0.0f, 0.0f};
    sh_color(p, l0, m0, c0);
    const int ln[3] = {link_at(p.links, p.X, p.Y, p.Z, x + 1, y, z),
                       link_at(p.links, p.X, p.Y, p.Z, x, y + 1, z),
                       link_at(p.links, p.X, p.Y, p.Z, x, y, z + 1)};
    float loss = 0.0f;
    for (int a = 0; a < 3; ++a) {
        if (ln[a] < 0) continue;
        float cn[3], ga[3];
        sh_color(p, ln[a], m0, cn);
        loss = loss + color_tv(cn, c0, p.scale, ga);
        add_sh(p, ln[a], ga, m0);
        for (int ch = 0; ch < 3; ++ch) g0[ch] = g0[ch] - ga[ch];
    }
    if (p.dir_factor > 0.0f) {
        const float* m1 = p.mult + p.bd;
        float cu[3], gu[3];
        sh_color(p, l0, m1, cu);
        loss = loss + p.dir_factor * color_tv(cu, c0, p.scale * p.dir_factor, gu);
        add_sh(p, l0, gu, m1);
        for (int ch = 0; ch < 3; ++ch) g0[ch] = g0[ch] - gu[ch];
    }
    add_sh(p, l0, g0, m0);
    return loss * p.scale;
}

// ---------------------------------------------------------------------------
// K12f: the TV of the MSI background (reg.py:673, msi_tv_grad_sparse), over
// sampled flat (u, v, layer) cells of the (2R, R) links x nlayers lattice:
// each channel's difference to the +u (wrapping), +v (clamped) and +layer
// (clamped) neighbours, 0 where a neighbour's link is -1; colour channels
// scaled by ``scaling``, density by ``scaling_density``; a cell whose link
// is -1 adds nothing. Bound: bytes (4 rows of 16 bytes a cell read, as many
// gradients added).
// ---------------------------------------------------------------------------

struct BgTVParams {
    const int* links;  // (W, H) = (2R, R)
    int W, H;
    const float* data;  // (n_rows, nlayers, 4)
    int nlayers;
    const int* cells;  // (n,)
    int64_t n;
    float scaling, scaling_density, scale;
    double* loss;
    float* g_data;
};

HD const float* bg_row(const BgTVParams& p, int l, int layer) {
    return p.data + ((int64_t)l * p.nlayers + layer) * 4;
}

HD float bg_tv_cell(const BgTVParams& p, int64_t n) {
    const int64_t c = p.cells[n];
    const int layer = (int)(c % p.nlayers);
    const int64_t uv = c / p.nlayers;
    const int64_t v = uv % p.H, u = (uv / p.H) % p.W;
    const int l0 = p.links[u * p.H + v];
    if (l0 < 0) return 0.0f;
    const int lu = p.links[((u + 1) % p.W) * p.H + v];
    const int lv = p.links[u * p.H + (v + 1 < p.H ? v + 1 : p.H - 1)];
    const int layer_n = layer + 1 < p.nlayers ? layer + 1 : p.nlayers - 1;
    const float* v0 = bg_row(p, l0, layer);
    const float* vl = bg_row(p, l0, layer_n);
    float tv[4];
    for (int ch = 0; ch < 4; ++ch) {
        const float du = lu >= 0 ? bg_row(p, lu, layer)[ch] - v0[ch] : 0.0f;
        const float dv = lv >= 0 ? bg_row(p, lv, layer)[ch] - v0[ch] : 0.0f;
        const float dl = vl[ch] - v0[ch];
        tv[ch] = sqrtf(1e-5f + du * du + dv * dv + dl * dl);
        const float gs = p.scale * (ch < 3 ? p.scaling : p.scaling_density) / tv[ch];
        const float gu = gs * du, gv = gs * dv, gl = gs * dl;
        if (gu != 0.0f) atomic_add(p.g_data + ((int64_t)lu * p.nlayers + layer) * 4 + ch, gu);
        if (gv != 0.0f) atomic_add(p.g_data + ((int64_t)lv * p.nlayers + layer) * 4 + ch, gv);
        if (gl != 0.0f) {
            atomic_add(p.g_data + ((int64_t)l0 * p.nlayers + layer_n) * 4 + ch, gl);
        }
        const float g0 = -(gu + gv + gl);
        if (g0 != 0.0f) atomic_add(p.g_data + ((int64_t)l0 * p.nlayers + layer) * 4 + ch, g0);
    }
    return (p.scaling * (tv[0] + tv[1] + tv[2]) + p.scaling_density * tv[3]) * p.scale;
}

// ---------------------------------------------------------------------------
// K12g: the TV of the learned 3D-texture basis (reg.py:717,
// inplace_tv_basis_grad, svox2.py:5959-5970): the mean over the (R-1)^3
// cells of the sum over channels of sqrt(1e-5 + dz^2 + dy^2 + dx^2), the
// forward differences of each channel, dense. One thread a (cell,
// channel); the gradient goes to the 4 touched values with atomics.
// Bound: bytes (the (R, R, R, bd) float32 texture read and its gradient
// written: 2.4 MB at R 32, bd 9, under a microsecond at 3.35 TB/s), so at
// this size the launch sets its time.
// ---------------------------------------------------------------------------

struct BasisTVParams {
    const float* data;  // (R, R, R, bd)
    int R, bd;
    int64_t n;  // (R-1)^3 bd
    float scale;
    double* loss;
    float* grad;
};

HD float basis_tv_cell(const BasisTVParams& p, int64_t i) {
    const int ch = (int)(i % p.bd);
    const int64_t cell = i / p.bd;
    const int64_t R1 = p.R - 1;
    const int64_t z = cell % R1, y = (cell / R1) % R1, x = cell / (R1 * R1);
    const int64_t sz = p.bd, sy = (int64_t)p.R * p.bd, sx = (int64_t)p.R * p.R * p.bd;
    const int64_t k0 = x * sx + y * sy + z * sz + ch;
    const float v0 = p.data[k0];
    const float dz = p.data[k0 + sz] - v0;
    const float dy = p.data[k0 + sy] - v0;
    const float dx = p.data[k0 + sx] - v0;
    const float tv = sqrtf(1e-5f + dz * dz + dy * dy + dx * dx);
    const float gs = p.scale / tv;
    const float gz = gs * dz, gy = gs * dy, gx = gs * dx;
    if (gz != 0.0f) atomic_add(p.grad + k0 + sz, gz);
    if (gy != 0.0f) atomic_add(p.grad + k0 + sy, gy);
    if (gx != 0.0f) atomic_add(p.grad + k0 + sx, gx);
    const float g0 = -(gz + gy + gx);
    if (g0 != 0.0f) atomic_add(p.grad + k0, g0);
    return tv * p.scale;
}

#ifdef __CUDACC__
constexpr int REG_BLOCK = 256;

// K6's TV of a channel range at least this wide runs a warp a window cell
constexpr int kTVWideChannels = 4;

__global__ void reg_tv_kernel(TVParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? tv_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_tv_wide_kernel(TVParams p) {
    const int64_t n = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    block_sum_atomic(n < p.n ? tv_cell_wide(p, n, threadIdx.x & 31) : 0.0f, p.loss);
}

__global__ void reg_tv_rows_kernel(TVParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? tv_row(p, n) : 0.0f, p.loss);
}

__global__ void reg_normal_kernel(NormalParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? normal_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_normal_rows_kernel(NormalParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? normal_row(p, n) : 0.0f, p.loss);
}

__global__ void reg_sparsify_kernel(SparsifyParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    float g_last = 0.0f;
    block_sum_atomic(n < p.n ? sparsify_cell(p, n, g_last) : 0.0f, p.loss);
    g_last = warp_sum(g_last);
    if ((threadIdx.x & 31) == 0 && g_last != 0.0f) atomicAdd(p.g_density + p.rows - 1, g_last);
}

__global__ void reg_norm_match_kernel(ExtParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? norm_match_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_viscosity_kernel(ExtParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? viscosity_cell(p, n) : 0.0f, p.loss);
}

// the gradient of row cap - 1, which every empty cell and neighbour reads,
// is summed over the block and added by one atomic
__global__ void reg_sign_change_kernel(ExtParams p) {
    __shared__ float last_sum;
    if (threadIdx.x == 0) last_sum = 0.0f;
    __syncthreads();
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    float last = 0.0f;
    const float loss = n < p.n ? sign_change_cell(p, n, last) : 0.0f;
    last = warp_sum(last);
    if ((threadIdx.x & 31) == 0 && last != 0.0f) atomicAdd(&last_sum, last);
    block_sum_atomic(loss, p.loss);  // its __syncthreads orders last_sum's adds
    if (threadIdx.x == 0 && last_sum != 0.0f)
        atomicAdd(p.g_surface + (int64_t)(p.cap - 1) * p.n_surf_c, last_sum);
}

__global__ void reg_eikonal_kernel(ExtParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? eikonal_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_lumisphere_kernel(ExtParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? lumisphere_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_background_tv_kernel(BgTVParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? bg_tv_cell(p, n) : 0.0f, p.loss);
}

__global__ void reg_basis_tv_kernel(BasisTVParams p) {
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    block_sum_atomic(n < p.n ? basis_tv_cell(p, n) : 0.0f, p.loss);
}

static unsigned n_blocks(int64_t n) { return (unsigned)((n + REG_BLOCK - 1) / REG_BLOCK); }

// K6's TV at window cells (cells, n of them) or, with cells null, at every
// lattice cell through the n rows of row_coords; the loss is expected to
// hold the empty cells' share (links.size k_empty scale) in every-cell mode
extern "C" cudaError_t reg_tv(const int* links, int X, int Y, int Z, const int* cells,
                              const int* row_coords, long long n, const float* data,
                              long long rows, int C, int c0, int c1, const float* wdens,
                              long long wrows, float scale, float k_empty, double* loss,
                              float* grad, void* stream) {
    if (n <= 0) return cudaSuccess;
    const TVParams p{links, X, Y, Z, cells, row_coords, n, data, rows, C, c0, c1, wdens, wrows,
                     scale, k_empty, loss, grad};
    const cudaStream_t s = (cudaStream_t)stream;
    if (!cells)
        reg_tv_rows_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p);
    else if (c1 - c0 >= kTVWideChannels)
        reg_tv_wide_kernel<<<n_blocks(n * 32), REG_BLOCK, 0, s>>>(p);
    else
        reg_tv_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p);
    return cudaGetLastError();
}

// K6's normal at window cells or, with cells null, at every cell of the
// interior box through the n rows of row_coords
extern "C" cudaError_t reg_normal(const int* links, int X, int Y, int Z, const int* cells,
                                  const int* row_coords, long long n, const float* surf,
                                  int n_surf_c, const float* level_sets, int n_lv, int con_check,
                                  int ignore_empty, int use_l1, float scale, double* loss,
                                  float* grad, void* stream) {
    if (n <= 0) return cudaSuccess;
    const NormalParams p{links, X, Y, Z, cells, row_coords, n, surf, n_surf_c, level_sets, n_lv,
                         con_check, ignore_empty, use_l1, scale, loss, grad};
    const cudaStream_t s = (cudaStream_t)stream;
    if (cells)
        reg_normal_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p);
    else
        reg_normal_rows_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p);
    return cudaGetLastError();
}

extern "C" cudaError_t reg_sparsify(const int* links, int X, int Y, int Z, const int* cells,
                                    long long n, const float* density, long long rows,
                                    const float* surf, int n_surf_c, float scale_alpha,
                                    float scale_surf, float surf_sign, float surf_thresh,
                                    float scale, double* loss,
                                    float* g_density, float* g_surface, void* stream) {
    if (n <= 0) return cudaSuccess;
    const SparsifyParams p{links, X, Y, Z, cells, n, density, rows, surf, n_surf_c, scale_alpha,
                           scale_surf, surf_sign, surf_thresh, scale, loss, g_density, g_surface};
    reg_sparsify_kernel<<<n_blocks(n), REG_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}
// K12a-K12e: ``kind`` 0 norm match, 1 viscosity, 2 sign change, 3 eikonal,
// 4 lumisphere TV (which reads sh, mult and dir_factor and writes g_sh)
extern "C" cudaError_t reg_ext(int kind, const int* links, int X, int Y, int Z, const int* cells,
                               long long n, int cap, const float* surf, int n_surf_c,
                               const float* density, long long n_dens, const float* h,
                               float eta, float target,
                               float scale, double* loss, float* g_surface, float* g_density,
                               const float* sh, int bd, const float* mult, float dir_factor,
                               float* g_sh, void* stream) {
    if (n <= 0) return cudaSuccess;
    const ExtParams p{links, X, Y, Z, cells, n, cap, surf, n_surf_c, density, n_dens, h, eta,
                      target, scale, loss, g_surface, g_density, sh, bd, mult, dir_factor, g_sh};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (kind) {
        case 0: reg_norm_match_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p); break;
        case 1: reg_viscosity_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p); break;
        case 2: reg_sign_change_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p); break;
        case 3: reg_eikonal_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p); break;
        case 4: reg_lumisphere_kernel<<<n_blocks(n), REG_BLOCK, 0, s>>>(p); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// K12f
extern "C" cudaError_t reg_background_tv(const int* links, int W, int H, const float* data,
                                         int nlayers, const int* cells, long long n,
                                         float scaling, float scaling_density, float scale,
                                         double* loss, float* g_data, void* stream) {
    if (n <= 0) return cudaSuccess;
    const BgTVParams p{links, W, H, data, nlayers, cells, n, scaling, scaling_density, scale,
                       loss, g_data};
    reg_background_tv_kernel<<<n_blocks(n), REG_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}

// K12g
extern "C" cudaError_t reg_basis_tv(const float* data, int R, int bd, float scale, double* loss,
                                    float* grad, void* stream) {
    if (R < 2 || bd <= 0) return cudaSuccess;
    const int64_t n = (int64_t)(R - 1) * (R - 1) * (R - 1) * bd;
    const BasisTVParams p{data, R, bd, n, scale, loss, grad};
    reg_basis_tv_kernel<<<n_blocks(n), REG_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
}
#endif
