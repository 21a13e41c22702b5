"""Time K8, the packed cuvol renderer's forward and backward kernels, at the
warm-start step's shape: bench_step's 256^3 cuvol grid (a smooth density
and SH field drawn from ``--seed``, the density kept positive so the pool is
the step's own), the first 40,960-ray batch of bench_step's camera, the
Config defaults' render options.

    python -m alphasurf_torch.app.bench_k8 [--reso 256] [--batch 40960] [--reps 10]

Prints one JSON line: the pool's size, the milliseconds of the forward and
of each backward instantiation (rgb only, with the depth and log_T
cotangents, with the basis gradient, both) by CUDA events, their bounds by
chip_smoke.py's formula, the atomics each backward issues, the registers
nvcc reported, and the card. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from alphasurf_torch import kernels
from alphasurf_torch.app.bench_step import bench_rays, build_cuvol_grid, cuvol_options
from alphasurf_torch.core.rays import Rays
from alphasurf_torch.render import cuvol as C

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
WIDTH = 800


def warm_case(reso: int, batch: int, device, seed: int = 0):
    """(grid, opt, chunk) of the warm step's first batch: bench_step's grid
    with a smooth field (density 0.1 (1 + 0.5 s), s in [-1, 1], so every
    voxel the step's pool holds stays occupied; SH 0.1 s), its camera's
    rays [0.35 n, 0.35 n + batch) and K2's pool over K1d's words."""
    grid, rc = build_cuvol_grid(reso, device)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=grid.links.device)
    freqs = torch.as_tensor(rng.normal(size=(3, 28)) * 2.0, **f32)
    phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, 28), **f32)
    with torch.no_grad():
        wave = torch.sin(rc.float() / reso @ freqs * (2 * np.pi / 2) + phase)
        grid.density_data.copy_(0.1 * (1.0 + 0.5 * wave[:, :1]))
        grid.sh_data.copy_(0.1 * wave[:, 1:])
    del wave, rc
    opt = cuvol_options()
    rays = bench_rays(WIDTH, device)
    s = int(rays.origins.shape[0] * 0.35)
    rays = Rays(rays.origins[s:s + batch].contiguous(), rays.dirs[s:s + batch].contiguous())
    ray_t = tuple(x.contiguous() for x in C._prep(grid, rays, opt))
    words = C.density_occupancy_words(grid)
    pool = C.cuvol_pool(grid, ray_t[0], ray_t[1], ray_t[4], ray_t[5], words)
    return grid, opt, C._CuvolChunk(grid, opt, pool, ray_t, None)


def sub_chunk(chunk, n: int):
    """The chunk of the first n rays: their pool entries and ray tensors."""
    p = chunk.pool
    m = int(p.offsets[n])
    pool = p._replace(ray_id=p.ray_id[:m], l=p.l[:m].contiguous(), close_t=p.close_t[:m],
                      far_t=p.far_t[:m], offsets=p.offsets[:n + 1].contiguous())
    return chunk._replace(pool=pool, rays=tuple(x[:n].contiguous() for x in chunk.rays))


def active_samples(chunk) -> int:
    """The samples K8 composites (active slots of every entry), counted in
    blocks of entries."""
    p, opt = chunk.pool, chunk.opt
    tmin, step, S = chunk.rays[4], opt.step_size, C.n_slots(opt)
    n = 0
    for a in range(0, p.close_t.shape[0], 1 << 22):
        close_t, far_t = p.close_t[a:a + (1 << 22)], p.far_t[a:a + (1 << 22)]
        tm = tmin[p.ray_id[a:a + (1 << 22)].long()]
        k0 = torch.ceil((close_t - tm) / step - 1e-9)
        t = tm[None] + (k0[None] + torch.arange(S, device=tm.device)[:, None]) * step
        n += int(((t < far_t[None]) & (t >= close_t[None] - 1e-9)).sum())
    return n


def corner_links(grid, l) -> torch.Tensor:
    """(M, 8) links of the corners of voxels l (M, 3)."""
    X, Y, Z = grid.reso
    off = torch.tensor([[c >> 2, (c >> 1) & 1, c & 1] for c in range(8)], device=l.device)
    v = l.long()[:, None, :] + off[None]
    return grid.links.reshape(-1)[(v[..., 0] * Y + v[..., 1]) * Z + v[..., 2]]


def k8_bound(grid, chunk) -> dict:
    """chip_smoke.py's bound of K8 (check_cuvol_kernels' in_bytes and
    entry_ops) at this chunk: each input byte read once, each output
    written once; ms, what bounds it, and the counts behind it."""
    p = chunk.pool
    B, M = chunk.rays[0].shape[0], p.close_t.shape[0]
    n_active = active_samples(chunk)
    links8 = corner_links(grid, p.l)
    n_rows = torch.unique(links8[links8 >= 0]).numel()  # the present corner rows
    del links8
    X, Y, Z = grid.reso
    l = p.l.long()
    vox = torch.unique((l[:, 0] * Y + l[:, 1]) * Z + l[:, 2])
    x, y, z = vox // (Y * Z), (vox // Z) % Y, vox % Z
    n_links = int(torch.unique(torch.stack([
        (torch.clamp(x + dx, max=X - 1) * Y + torch.clamp(y + dy, max=Y - 1)) * Z
        + torch.clamp(z + dz, max=Z - 1) for dx in (0, 1) for dy in (0, 1)
        for dz in (0, 1)])).numel())
    del l, vox, x, y, z
    in_bytes = M * 20 + (B + 1) * 8 + B * 72 + n_links * 4 + n_rows * 28 * 4
    entry_ops = M * 8 * 3 * 9 * 2
    cap = grid.capacity

    def bound(n_bytes, n_ops):
        t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    return {
        "rays": B, "entries": M, "samples": n_active, "corner_links": n_links,
        "corner_rows": n_rows,
        "forward": bound(in_bytes + B * 20 + M * 4, entry_ops + n_active * 120),
        "rgb": bound(in_bytes + B * 16 + M * 4 + cap * 28 * 4, 2 * entry_ops + n_active * 250),
        "out": bound(in_bytes + B * 24 + M * 4 + cap * 28 * 4, 2 * entry_ops + n_active * 254),
        "basis": bound(in_bytes + B * 16 + M * 4 + cap * 28 * 4 + B * grid.basis_dim * 4,
                       M * 8 * 3 * 9 * 4),
        "out_basis": bound(in_bytes + B * 24 + M * 4 + cap * 28 * 4 + B * grid.basis_dim * 4,
                           M * 8 * 3 * 9 * 4),
    }


def atomic_counts(grid, chunk) -> dict:
    """Atomics of one backward launch with every cotangent non-zero (zeros
    are skipped, so these are upper bounds). One thread a ray added every
    present corner channel of every entry, 8 (1 + 3 bd) scalar atomics an
    entry. The warp design hands the corners an entry shares with the entry
    before it down the ray, then adds each remaining corner's density (a
    scalar atomic) and its SH row in float4 atomics, one a 16-byte slot the
    row's 3 bd floats touch."""
    p = chunk.pool
    C3 = 3 * grid.basis_dim
    n_e = p.offsets[1:] - p.offsets[:-1]
    M = p.close_t.shape[0]
    present = flushed = slots = 0
    for a in range(0, M, 1 << 22):
        b = min(a + (1 << 22), M)
        cur = corner_links(grid, p.l[a:b])
        added = cur >= 0
        present += int(added.sum())
        i = max(a, 1)  # entries i..b-1 beside the entry before each
        if i < b:
            prev = corner_links(grid, p.l[i - 1:b - 1])
            same_ray = (p.ray_id[i:b] == p.ray_id[i - 1:b - 1])[:, None]
            added[i - a:] &= ~((cur[i - a:, :, None] == prev[:, None, :]).any(-1) & same_ray)
        rows = cur[added].long()
        flushed += rows.numel()
        slots += int(((rows * C3) % 4 + C3 + 3).div(4, rounding_mode="floor").sum())
    return {"rays_with_entries": int((n_e > 0).sum()), "present_corners": present,
            "before": {"scalar_atomics": present * (1 + C3)},
            "after": {"scalar_atomics": flushed, "float4_atomics": slots,
                      "floats_added": flushed * (1 + C3)}}


def time_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k8_calls(chunk, seed: int = 0) -> dict:
    """The forward (with entry_pre, as in training) and the four backward
    instantiations on this chunk, as zero-argument calls; the cotangents
    drawn from ``seed``."""
    grid = chunk.grid
    dens = grid.density_data.detach()[:, 0].contiguous()
    sh = grid.sh_data.detach()
    B = chunk.rays[0].shape[0]
    fk = C._k8_forward(chunk, dens, sh, True)
    rng = np.random.default_rng(seed + 14)
    dev = dens.device
    g_rgb, g_depth, g_log_T = (torch.as_tensor(rng.standard_normal(s) / B, dtype=torch.float32,
                                               device=dev) for s in ((B, 3), B, B))
    args = C._k8_args(chunk, dens, sh)

    def bwd(out: bool, basis: bool):
        return lambda: kernels.cuvol_backward(
            *args, fk["log_T"], fk["entry_pre"], g_rgb, want_sh_mult=basis,
            g_depth=g_depth if out else None, g_log_T=g_log_T if out else None)

    return {"forward": lambda: C._k8_forward(chunk, dens, sh, True),
            "rgb": bwd(False, False), "out": bwd(True, False), "basis": bwd(False, True),
            "out_basis": bwd(True, True)}


def registers() -> dict:
    """The registers nvcc reported for K8's kernels in this process's build
    (empty when the library was built before it)."""
    out, name = {}, None
    for ln in kernels.BUILD_LOG.get("cuvol", {}).get("ptxas", []):
        if "entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
        elif name and ("cuvol_forward_kernel" in name or "cuvol_backward_kernel" in name):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def run(reso: int = 256, batch: int = 40960, reps: int = 10, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    grid, opt, chunk = warm_case(reso, batch, dev, seed)
    calls = k8_calls(chunk, seed)
    ms = {k: time_ms(fn, reps) for k, fn in calls.items()}
    bound = k8_bound(grid, chunk)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return {"reso": reso, "batch": batch, "reps": reps, "ms": ms,
            "fwd_bwd_ms": ms["forward"] + ms["rgb"],
            "bound": bound, "atomics": atomic_counts(grid, chunk), "registers": registers(),
            "card": card}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reso", type=int, default=256)
    ap.add_argument("--batch", type=int, default=40960)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k8 needs a CUDA card")
    out = run(a.reso, a.batch, a.reps, a.seed)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
