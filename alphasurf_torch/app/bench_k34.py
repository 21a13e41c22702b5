"""Time K3 (phase B), K4 (the compositor) and K5 (their backward, K5a and
K5b) at the main path's three shapes, each on K2's pool: the serving chunk
(``bench_k2.serve_rays``, the 16,384 central rays of render_circle's first
800x800 frame, on chip_smoke.py's 512^3 shell grid under bench_step's render
options), the 512^3 surface step batch (``bench_k2.step_rays``, 40,960
rays) and a dense type chunk (the serving chunk's rays on a 256^3
VOXEL_FACE grid built as chip_smoke.py's ``type_grid``, under its type
options: ~280 entries a ray). K4 is also timed on an empty pool (the
background only), as on the chunks of a frame that hit nothing; K5a and K5b
on each shape's slots, rgb-only and in their second instantiations
(``backward_ray_out``, ``backward_entry_out``, on the arguments the
renderer passes them with every output's cotangent). Each time is taken
twice: per call as the host issues it (chip_smoke.py's time_ms: the
wrapper's host time included, which sets the time of a small launch) and on
the device alone (a CUDA graph of the calls, replayed).

    python -m alphasurf_torch.app.bench_k34 [--reps 20]

At each shape K3 and K4 are first held against their plain versions under
chip_smoke.py's tolerances (check_kernels' on the shell, check_type_kernels'
on the type chunk), K5a's picks against K4's (``pick_disagreements``), and
K5a and K5b against autograd of the plain renderer under chip_smoke.py's
GRAD_* (``backward_check``: rgb and the ray losses, then every output's
cotangent). Prints one JSON line: for each shape the rays, entries and
slots, the milliseconds (per call and on the device), the bounds by
chip_smoke.py's formulas (K5's as its check_backward and k5b_work count
them), the checks' errors, the rays whose stop_thresh kill differs from the
plain version's and the rays whose K5a picks differ from K4's; the
registers nvcc reported and the card. Needs a card.

Another checkout's kernels are timed in the same call by running this file
from that checkout's root with the checkout on PYTHONPATH (``cd
build/parent && PYTHONPATH=$PWD python <this tree>/alphasurf_torch/app/bench_k34.py``):
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess

import numpy as np
import torch

from alphasurf_torch import defs, kernels
from alphasurf_torch.app import bench_k2
from alphasurf_torch.app.bench_k8 import time_ms
from alphasurf_torch.app.bench_step import bench_options, build_bench_grid
from alphasurf_torch.core.grid import create_grid
from alphasurf_torch.core.options import RenderOptions
from alphasurf_torch.render import surface as S

# chip_smoke.py's tolerances of K3 and K4 against their plain versions
RTOL, ATOL = 1e-4, 1e-5
SELECT_FRACTION = 1e-3
FLAG_FRACTION = 1e-5
ROOT_FRACTION = 1e-4
TYPE_OPT = dict(sigma_thresh=-1e9, stop_thresh=1e-7)  # chip_smoke.py's TYPE_BASE_OPT
SMP_KEYS = ("t", "alpha", "contrib", "fake", "counted", "rgb", "snorm", "loss_e")
# chip_smoke.py's tolerances of K5 against autograd of the plain renderer:
# |g_k - g_p| <= GRAD_REL |g_p| in norm, and at most GRAD_ROW_FRACTION of
# the touched rows with an element outside GRAD_ATOL + GRAD_RTOL |g_p|
GRAD_REL, GRAD_ROW_FRACTION, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4, 1e-3, 1e-6
SIG_THRESH = 0.2  # the sigma-thresh depth's threshold of the output checks


def shell_grid(reso: int, device, seed: int = 0):
    """bench.py's sparse sphere-shell SDF grid (reso^3, one level set,
    basis_dim 9, fake_sample_std 0.1), built on the card, with raw alpha in
    [0.5, 3] and a smooth SH colour field drawn from a numpy seed; and its
    row coords (chip_smoke.py's grid)."""
    grid, row_coords = build_bench_grid(reso, device)
    coords = row_coords.float() / reso
    rng = np.random.default_rng(seed)
    freqs = torch.as_tensor(rng.normal(size=(3, 27)) * 2.0, dtype=torch.float32, device=device)
    phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, 27), dtype=torch.float32, device=device)
    with torch.no_grad():
        grid.sh_data.copy_(0.35 * torch.sin(coords @ freqs * (2 * np.pi / 4) + phase))
        grid.density_data.copy_(torch.as_tensor(rng.uniform(0.5, 3.0, (grid.capacity, 1)),
                                                dtype=torch.float32, device=device))
    return grid, row_coords


def voxel_face_grid(reso: int, device, seed: int = 0):
    """chip_smoke.py's type_grid("voxel_face"): create_grid with the sphere
    bound and basis_dim 9, SH 0.3 N(0, 1) and raw alpha uniform in [0.5, 3]
    from ``seed``."""
    grid = create_grid(reso, surface_type=defs.SURFACE_TYPE_VOXEL_FACE, surface_init=None,
                       use_sphere_bound=True, basis_dim=9, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        grid.sh_data.copy_(0.3 * torch.randn(grid.sh_data.shape, generator=gen, device=device))
        grid.density_data.uniform_(0.5, 3.0, generator=gen)
    return grid


def chunk_case(grid, opt, rays):
    """K2's pool of ``rays`` and the K3 inputs of the chunk."""
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, _ = S._prep(grid, rays, opt)
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    origins, dirs, sh_mult, tn, tx = (x.contiguous() for x in (origins, dirs, sh_mult, tn, tx))
    words = S.occupancy_words(grid, opt)
    pool = bench_k2.kernel_pool(grid.reso, origins, dirs, tn, tx, words)
    return dict(grid=grid, opt=opt, pool=pool, origins=origins, dirs=dirs, sh_mult=sh_mult,
                ngt=ngt, packed=S.pack_grid_data(grid).detach().contiguous())


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one fn() call: reps calls captured in a CUDA
    graph, replayed three times between CUDA events. Unlike time_ms, which
    times calls as the host issues them, this leaves out the wrapper's
    host time, which is longer than a small kernel's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def timed(fn, reps: int) -> dict:
    """A call's milliseconds as issued from the host (time_ms, chip_smoke.py's
    way) and on the device alone (graph_ms)."""
    return {"call": time_ms(fn, reps), "device": graph_ms(fn, reps)}


def allclose_err(a, b, rtol=RTOL, atol=ATOL) -> tuple[float, float]:
    """(max abs error, fraction of elements outside atol + rtol |b|)."""
    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0, 0.0
    d = (a - b).abs()
    return float(d.max()), float((d > atol + rtol * b.abs()).float().mean())


def k3_call(c):
    g, p = c["grid"], c["pool"]
    return lambda: kernels.phase_b(p.ray_id, p.l, p.close_t, p.far_t, c["origins"], c["dirs"],
                                   c["sh_mult"], g.links, c["packed"], S._surface_spec(g),
                                   g.level_set_data, c["ngt"], S._fss(g), c["opt"])


def k4_call(c, smp, offsets=None):
    offsets = c["pool"].offsets if offsets is None else offsets
    return lambda: kernels.composite(offsets, smp, c["grid"].truncated_vol_render_a,
                                     c["opt"], None, True)


def corner_rows(grid, l) -> tuple[int, int]:
    """(distinct corner vertices, present rows among them) of the pool's voxels."""
    R = grid.links.shape
    lk = torch.unique(torch.stack([
        ((torch.clamp(l[:, 0].long() + dx, max=R[0] - 1) * R[1]
          + torch.clamp(l[:, 1].long() + dy, max=R[1] - 1)) * R[2]
         + torch.clamp(l[:, 2].long() + dz, max=R[2] - 1))
        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    return lk.numel(), int((grid.links.reshape(-1)[lk] >= 0).sum())


def bounds(c, S0: int, n_le: int, typed: bool) -> dict:
    """chip_smoke.py's bounds: K3 (check_kernels' on the shell, and
    check_type_kernels' on a type chunk) and K4."""
    g, M, B = c["grid"], c["pool"].close_t.shape[0], c["origins"].shape[0]
    C8, bd = c["packed"].shape[1], g.basis_dim
    n_vert, n_rows = corner_rows(g, c["pool"].l)
    if typed:
        nb3 = M * 24 + B * 60 + n_vert * 4 + n_rows * C8 * 4 + S0 * M * 38 + n_le * M * 4
        ops3 = M * (48 * bd + 60 + S0 * 200)
    else:
        nb3 = M * 24 + B * 60 + n_vert * (4 + C8 * 4) + S0 * M * 38 + 3 * M * 4
        ops3 = M * (48 * bd + 60 + g.level_set_data.numel() * 550 + 200)
    nb4 = S0 * M * 42 + 3 * M * 4 + (B + 1) * 8 + B * 92
    return {"phase_b": bench_k2.bound_ms(nb3, ops3),
            "composite": bench_k2.bound_ms(nb4, S0 * M * 50)}


def check_k3(c, sk, typed: bool) -> dict:
    sp = S._voxel_samples_plain(c["grid"], c["opt"], c["pool"], c["origins"], c["dirs"],
                                c["sh_mult"], c["ngt"], c["packed"])
    flips = sum(int((sk[k] != sp[k]).sum()) for k in ("contrib", "fake", "counted"))
    live = sp["contrib"] | (sp["counted"] > 0)
    errs = [allclose_err(sk["t"][live], sp["t"][live], rtol=1e-5, atol=1e-4)]
    errs += [allclose_err(sk[k], sp[k]) for k in ("alpha", "rgb", "snorm")]
    errs += [allclose_err(sk["loss_e"], sp["loss_e"], atol=1e-4)]
    limit = ROOT_FRACTION if typed else 0.0
    ok = flips <= FLAG_FRACTION * sp["contrib"].numel() and max(e[1] for e in errs) <= limit
    return {"ok": ok, "flag_flips": flips, "max_abs_err": max(e[0] for e in errs),
            "frac_out": max(e[1] for e in errs), "plain": sp}


def check_k4(c, ck, sp, typed: bool) -> dict:
    opt, B = c["opt"], c["origins"].shape[0]
    cp = S._composite_plain(opt, c["grid"].truncated_vol_render_a, c["pool"].offsets, sp)
    n_int = torch.equal(ck["n_intersections"], cp["n_intersections"])
    keys = ("rgb", "log_T") if typed else ("rgb", "normal", "log_T", "weight")
    keys4 = ("ray_losses",) if typed else ("depth", "ray_losses")
    errs = [allclose_err(ck[k], cp[k]) for k in keys]
    errs += [allclose_err(ck[k], cp[k], atol=1e-4) for k in keys4]
    sel = [] if typed else [allclose_err(ck[k], cp[k], atol=1e-3)
                            for k in ("depth_mode", "depth_med")]
    # where an output is outside its tolerance: its worst element
    worst = {}
    for k, e in zip(keys + keys4, errs):
        if e[1] > 0:
            d = (ck[k].double() - cp[k].double()).abs() - (1e-4 if k in keys4 else ATOL) \
                - RTOL * cp[k].double().abs()
            i = int(d.reshape(-1).argmax())
            idx = [int(x) for x in np.unravel_index(i, d.shape)]
            worst[k] = {"index": idx, "n_out": int((d > 0).sum()),
                        "kernel": float(ck[k].reshape(-1)[i]), "plain": float(cp[k].reshape(-1)[i]),
                        "float64": ray_float64(c, sp, idx[-1] if k != "weight" else None, k, idx)}
    # a ray whose live flags differ: its stop_thresh kill fell at another entry
    live_diff = (ck["live"] != cp["live"]).any(0)
    kill_rays = torch.unique(c["pool"].ray_id[live_diff]).numel()
    ok = n_int and max(e[1] for e in errs) == 0 and max([0.0] + [e[1] for e in sel]) <= \
        SELECT_FRACTION
    return {"ok": ok, "n_intersections_equal": n_int, "max_abs_err": max(e[0] for e in errs),
            "picks_off": [round(e[1] * B) for e in sel], "kill_rays_differ": kill_rays,
            "outside": worst}


def ray_float64(c, sp, r, key, idx):
    """The plain version's ``key`` at ``idx`` for ray r alone, in float64
    on the host: which of kernel and plain float32 is nearer."""
    if r is None:
        return None
    o = c["pool"].offsets
    a, b = int(o[r]), int(o[r + 1])
    one = {k: (v[..., a:b].cpu().double() if v.dtype == torch.float32 else v[..., a:b].cpu())
           for k, v in sp.items() if torch.is_tensor(v)}
    out = S._composite_plain(c["opt"], c["grid"].truncated_vol_render_a.detach().cpu().double(),
                             torch.tensor([0, b - a]), one)
    v = out[key]
    return float(v[idx[0], 0] if v.dim() == 2 else v[0])


def pick_disagreements(pool, smp, trunc_a, opt) -> dict:
    """Rays whose K5a picks differ from K4's, under ``opt`` and under it
    with stop_thresh 0.3 and no truncation (kills mid-ray), each by the
    packed renderer's rules and by the walks' (first-maximum mode, an
    8-sample cache). K4 renders the pool; then K5a takes a cotangent of 1
    on one of its one-sample depths alone (the mode, the median, the
    sigma-thresh depth at 0.2, the cache's median), and its d_t is 1, split
    over ties, on the slots it picks and 0 elsewhere: a ray differs where
    those slots' t is not K4's depth or their cotangents do not sum to 1
    (to 0 where K4's depth is 0, no pick). ``kill``: without truncation a
    cotangent of 1 on the live slots' truncated alphas alone gives d_alpha
    1 on the slots K5a takes as live and 0 elsewhere; a ray differs where
    those are not K4's live flags."""
    B = pool.offsets.shape[0] - 1
    dev = pool.offsets.device
    ray = pool.ray_id.long()
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    g_rgb = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    g_rl = torch.zeros((12, B), dtype=torch.float32, device=dev)

    def per_ray(x):
        return torch.zeros(B, dtype=torch.float64, device=dev).index_add_(0, ray, x)

    out = {"kill": 0, "mode": 0, "med": 0, "sig": 0, "mode_first": 0, "cache_med": 0}
    kill_opt = dataclasses.replace(opt, stop_thresh=0.3, truncated_vol_render=False)
    for o in (opt, kill_opt):
        for first, K in ((False, None), (True, 8)):
            ck = kernels.composite(pool.offsets, smp, trunc_a, o, 0.2, True, 0, first, K)
            g_c = None if K is None else tuple(torch.zeros((B, K), dtype=torch.float32,
                                                           device=dev) for _ in range(3))
            picks = {"mode": "depth_mode", "med": "depth_med", "sig": "depth_sigma_thresh"}
            if K is not None:
                picks = {"mode": "depth_mode", "cache_med": "cache_med"}
            for name, key in picks.items():
                d_t = kernels.backward_ray(
                    pool.offsets, smp, trunc_a, o, g_rgb, g_rl, g_c,
                    out=kernels.OutCotangents(**{name: ones}), mode_first=first,
                    sig_thresh=0.2)[1]
                depth = ck[key]
                picked = d_t != 0
                off_t = per_ray((picked & (smp["t"] != depth[ray][None])).any(0).double()) > 0
                tot = per_ray(d_t.sum(0).double())
                bad = off_t | torch.where(depth != 0, (tot - 1).abs() > 1e-5, tot != 0)
                out["mode_first" if name == "mode" and first else name] += int(bad.sum())
            if o is kill_opt and not first:
                d_a = kernels.backward_ray(pool.offsets, smp, trunc_a, o, g_rgb, g_rl,
                                           out=kernels.OutCotangents(
                                               live_alpha=torch.ones_like(smp["t"])))[0]
                diff = ((d_a != 0) != ck["live"]).any(0)
                out["kill"] += int(torch.unique(ray[diff]).numel())
    return out


def grad_stats(gk, gp) -> dict:
    """chip_smoke.py's grad_stats: the kernel gradient ``gk`` against the
    plain ``gp`` on one parameter group, its rel err in norm, the touched
    rows and those outside GRAD_RTOL / GRAD_ATOL, the max abs err."""
    gk, gp = gk.double().reshape(gk.shape[0], -1), gp.double().reshape(gp.shape[0], -1)
    d = (gk - gp).abs()
    touched = (gk != 0).any(-1) | (gp != 0).any(-1)
    bad = (d > GRAD_ATOL + GRAD_RTOL * gp.abs()).any(-1) & touched
    return {"rel": float((gk - gp).norm() / gp.norm().clamp(min=1e-30)), "bad": int(bad.sum()),
            "touched": int(touched.sum()), "max_abs": float(d.max()) if d.numel() else 0.0}


def grad_ok(st: dict) -> bool:
    return st["rel"] <= GRAD_REL and st["bad"] <= GRAD_ROW_FRACTION * max(st["touched"], 1)


@contextlib.contextmanager
def recorded_calls(names=("backward_ray", "backward_entry")):
    """Records the arguments of the first call of each kernels function of
    ``names`` while the block runs (the calls go through)."""
    calls, orig = {}, {n: getattr(kernels, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            calls.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    for n, fn in orig.items():
        setattr(kernels, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(kernels, n, fn)


def slot_points(grid, pool, origins, dirs, t):
    """The world point of every slot, entry-major, by torch ops (autograd)."""
    rid = pool.ray_id.long()
    p = origins[rid].T[:, None, :] + t[None] * dirs[rid].T[:, None, :]
    return grid.grid2world(p.permute(2, 1, 0).reshape(-1, 3))


def backward_check(c, every: bool = False, mode=S.PACKED, sig: float | None = None,
                   seed: int = 0) -> dict:
    """K5a and K5b against autograd of the plain renderer on the same pool
    and device: the gradients into density, surface, SH and
    fake_sample_std of a loss with random cotangents (from ``seed``, at the
    scale 1 / B) on rgb and every ray loss, through the renderer's autograd
    Function (_SurfaceFn: K3 and K4 forward, K5a and K5b backward) and
    through autograd of the plain K3 and K4. ``every``: a cotangent on
    every other output too (depth, normal, log_T, the mode and median
    depths, the sigma-thresh depth with ``sig``, the slots' t, alphas and
    weights, the intersections' points or, with ``mode``'s cache, the cache
    and the samples' alphas), through K5a's and K5b's second
    instantiations. A ray whose picked depth differs between K4 and the
    plain version (a near-tie) takes no cotangent on it on either side.
    Returns each group's grad_stats, ``ok`` under GRAD_*, the rays so
    masked, the slots whose live flags differ and the arguments of K5a's and
    K5b's launches (``calls``)."""
    g, opt, pool = c["grid"], c["opt"], c["pool"]
    origins, dirs, sh_mult, ngt = c["origins"], c["dirs"], c["sh_mult"], c["ngt"]
    B = origins.shape[0]
    dev = origins.device
    cache = mode.cache_size is not None
    want_live, want_samples = every and not cache, every and cache
    keys = ["rgb", "ray_losses"]
    if every:
        keys += ["depth", "normal", "log_T", "depth_mode", "t", "alpha", "weight"]
        keys += (["cache_med", "ts", "alphas", "weights", "live_alpha"] if cache
                 else ["depth_med", "pts"])
        keys += ["depth_sigma_thresh"] if sig is not None else []
    names = ("density", "surface", "sh", "fake_sample_std")
    params = [g.density_data, g.surface_data, g.sh_data, g.fake_sample_std]
    used = [p for p in params if p is not None]
    for p in used:
        p.requires_grad_(True)
    try:
        chunk = S._Chunk(g, opt, pool, origins, dirs, sh_mult.detach().contiguous(), ngt,
                         c["packed"], mode, sig, want_live, want_samples)
        res = S._SurfaceFn.apply(*params, None, sh_mult, chunk)
        out_k = dict(zip(S._FN_OUTPUTS + S._CACHE_KEYS, res))
        smp = S._voxel_samples_plain(g, opt, pool, origins, dirs, sh_mult, ngt,
                                     S.pack_grid_data(g))
        out_p = S._composite_plain(opt, g.truncated_vol_render_a, pool.offsets, smp, sig, *mode)
        out_p.update(t=smp["t"], alpha=smp["alpha"])
        if cache:
            out_p.update(out_p.pop("cache"))
        if want_live:
            out_p["pts"] = slot_points(g, pool, origins, dirs, smp["t"])
        gen = torch.Generator().manual_seed(seed)
        w = {k: (torch.randn(tuple(out_k[k].shape), generator=gen, dtype=torch.float64) / B)
             .float().to(dev) for k in keys}
        keep = {}
        for k in ("depth_mode", "depth_med", "cache_med", "depth_sigma_thresh"):
            if k in keys:
                a, b = out_k[k].detach(), out_p[k].detach()
                keep[k] = (a - b).abs() <= 1e-3 + RTOL * b.abs()

        def loss(out):
            return sum(torch.where(keep[k], out[k] * w[k], torch.zeros_like(w[k])).sum()
                       if k in keep else (out[k] * w[k]).sum() for k in keys)

        with recorded_calls() as calls:
            gk = torch.autograd.grad(loss(out_k), used, allow_unused=True)
        gp = torch.autograd.grad(loss(out_p), used, allow_unused=True)
        gk, gp = ([torch.zeros_like(q) if x is None else x for q, x in zip(used, gs)]
                  for gs in (gk, gp))
        live_flips = int((out_k["weight"].detach() > 0).ne(out_p["weight"].detach() > 0).sum())
    finally:
        for p in used:
            p.requires_grad_(False)
    stats = {n: grad_stats(a, b) for n, a, b in zip(
        [n for n, p in zip(names, params) if p is not None], gk, gp)}
    return {"ok": all(grad_ok(st) for st in stats.values()), "stats": stats,
            "picks_masked": {k: int((~m).sum()) for k, m in keep.items()},
            "live_flips": live_flips, "calls": calls}


def k5_work(c, S0: int) -> dict:
    """K5a's and K5b's bytes and operations at a shape, as chip_smoke.py's
    check_backward (K5a) and k5b_work (K5b) count them: K5a reads each
    slot's t, alpha, flags and colour and writes its cotangents (46 bytes a
    slot), the second instantiation also the output cotangents, the ray's
    direction, the slot's point, alpha, weight and normal cotangents and
    K3's normal, and writes d_snorm; K5b reads the pool, its rays, the
    corner links and rows and the slot cotangents (with d_snorm) and writes
    the gradient arrays."""
    g, pool, packed = c["grid"], c["pool"], c["packed"]
    M, B = pool.close_t.shape[0], c["origins"].shape[0]
    n_vert, n_rows = corner_rows(g, pool.l)
    n_grad = g.density_data.numel() + g.surface_data.numel() + g.sh_data.numel()
    bytes_a = S0 * M * 46 + (B + 1) * 8 + B * 60
    bytes_ao = bytes_a + B * (32 + 12) + S0 * M * (20 + 12 + 12)
    out = {"backward_ray": bench_k2.bound_ms(bytes_a, S0 * M * 100),
           "backward_ray_out": bench_k2.bound_ms(bytes_ao, S0 * M * 130)}
    for name, normal in (("backward_entry", 0), ("backward_entry_out", 1)):
        nb = (M * 24 + B * 60 + n_vert * 4 + n_rows * packed.shape[1] * 4
              + S0 * M * (21 + 12 * normal) + B * 8 + n_grad * 4)
        ops = (M * 2 * (48 * g.basis_dim + 60 + g.level_set_data.numel() * 550 + 200)
               + S0 * M * 2 * 120 * normal)
        out[name] = bench_k2.bound_ms(nb, ops)
    return out


def shape_case(label: str, c, reps: int, typed: bool) -> dict:
    """One shape: K3 and K4 against their plain versions and K5a's picks
    against K4's, then K3, K4, K5a and K5b timed."""
    B, M = c["origins"].shape[0], c["pool"].close_t.shape[0]
    k3 = k3_call(c)
    sk = k3()
    c3 = check_k3(c, sk, typed)
    sp = c3.pop("plain")
    smp = {k: sp[k].contiguous() for k in SMP_KEYS}
    k4 = k4_call(c, smp)
    c4 = check_k4(c, k4(), sp, typed)
    del sp
    picks = pick_disagreements(c["pool"], smp, c["grid"].truncated_vol_render_a, c["opt"])
    # K5a and K5b against autograd of the plain renderer: rgb-only, then
    # every output's cotangent (the second instantiations); each timed on
    # the arguments the renderer passed it
    bw = backward_check(c)
    bo = backward_check(c, every=True, sig=SIG_THRESH)
    calls, calls_out = bw.pop("calls"), bo.pop("calls")
    (a_ray, kw_ray), (a_ent, kw_ent) = calls["backward_ray"], calls["backward_entry"]
    (o_ray, ko_ray), (o_ent, ko_ent) = calls_out["backward_ray"], calls_out["backward_entry"]
    S0 = sk["n_slots"]
    return {"shape": label, "reso": list(c["grid"].reso), "rays": B, "entries": M, "slots": S0,
            "max_entries_a_ray": int((c["pool"].offsets[1:] - c["pool"].offsets[:-1]).max()),
            "check": {"phase_b": c3, "composite": c4,
                      "backward_picks": {"ok": not any(picks.values()), "rays_differ": picks},
                      "backward": bw, "backward_out": bo},
            "ms": {"phase_b": timed(k3, reps), "composite": timed(k4, reps),
                   "backward_ray": timed(lambda: kernels.backward_ray(*a_ray, **kw_ray), reps),
                   "backward_entry": timed(lambda: kernels.backward_entry(*a_ent, **kw_ent), reps),
                   "backward_ray_out": timed(lambda: kernels.backward_ray(*o_ray, **ko_ray), reps),
                   "backward_entry_out": timed(lambda: kernels.backward_entry(*o_ent, **ko_ent),
                                               reps)},
            "bound": {**bounds(c, S0, sk["loss_e"].shape[0], typed), **k5_work(c, S0)},
            "_smp": smp}


def empty_pool_ms(c, smp, reps: int) -> float:
    """K4 on the chunk's rays with no entries: it writes the background."""
    offsets = torch.zeros_like(c["pool"].offsets)
    empty = {k: v[..., :0].contiguous() for k, v in smp.items()}
    return timed(k4_call(c, empty, offsets), reps)


def registers() -> dict:
    """The registers and spills nvcc reported for K3's, K4's and K5's
    kernels in this process's build (empty when the libraries were built
    before it)."""
    out = {}
    for lib in ("phase_b", "composite", "backward"):
        name = None
        for ln in kernels.BUILD_LOG.get(lib, {}).get("ptxas", []):
            if "entry function" in ln:
                name = ln.split("'")[1] if "'" in ln else None
            elif name and any(k in name for k in ("phase_b", "composite", "backward")):
                out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def run(reps: int = 20, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    kernels.build()
    cases = []
    grid, _ = shell_grid(512, dev, seed)
    opt = bench_options()
    for label, rays in (("serve", bench_k2.serve_rays(dev)), ("surface", bench_k2.step_rays(dev))):
        c = chunk_case(grid, opt, rays)
        case = shape_case(label, c, reps, typed=False)
        smp = case.pop("_smp")
        if label == "serve":
            case["ms"]["composite_empty"] = empty_pool_ms(c, smp, reps)
        cases.append(case)
    del grid
    torch.cuda.empty_cache()
    c = chunk_case(voxel_face_grid(256, dev, seed), RenderOptions(**TYPE_OPT),
                   bench_k2.serve_rays(dev))
    case = shape_case("voxel_face", c, reps, typed=True)
    case.pop("_smp")
    cases.append(case)
    out = {"reps": reps, "package": kernels.__file__, "cases": cases, "registers": registers()}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k34 needs a CUDA card")
    out = run(a.reps, a.seed)
    print(json.dumps(out), flush=True)
    if not all(c["check"][k]["ok"] for c in out["cases"]
               for k in ("phase_b", "composite", "backward_picks", "backward", "backward_out")):
        raise SystemExit("K3 or K4 differs from its plain version, K5a's picks from K4's, or K5 "
                         "from autograd of the plain renderer")
    return out


if __name__ == "__main__":
    main()
