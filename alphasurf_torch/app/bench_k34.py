"""Time K3 (phase B) and K4 (the compositor) at the main path's three
shapes, each on K2's pool: the serving chunk (``bench_k2.serve_rays``, the
16,384 central rays of render_circle's first 800x800 frame, on
chip_smoke.py's 512^3 shell grid under bench_step's render options), the
512^3 surface step batch (``bench_k2.step_rays``, 40,960 rays) and a dense
type chunk (the serving chunk's rays on a 256^3 VOXEL_FACE grid built as
chip_smoke.py's ``type_grid``, under its type options: ~280 entries a ray).
K4 is also timed on an empty pool (the background only), as on the chunks of
a frame that hit nothing, and K5a and K5b, which read K3's and K4's outputs
(K5b shares K3's samples.cuh), on each shape's slots. Each time is taken
twice: per call as the host issues it (chip_smoke.py's time_ms: the
wrapper's host time included, which sets the time of a small launch) and on
the device alone (a CUDA graph of the calls, replayed).

    python -m alphasurf_torch.app.bench_k34 [--reps 20]

At each shape K3 and K4 are first held against their plain versions under
chip_smoke.py's tolerances (check_kernels' on the shell, check_type_kernels'
on the type chunk), and K5a's picks against K4's (``pick_disagreements``).
Prints one JSON line: for each shape the rays, entries and slots, K3's,
K4's, K5a's and K5b's milliseconds by CUDA events (per call and on the
device), K3's and K4's bounds by chip_smoke.py's formulas, the checks'
errors, the rays whose stop_thresh kill differs from the plain version's
and the rays whose K5a picks differ from K4's; the registers nvcc reported
and the card. Needs a card.

Another checkout's kernels are timed in the same call by running this file
from that checkout's root with the checkout on PYTHONPATH (``cd
build/parent && PYTHONPATH=$PWD python <this tree>/alphasurf_torch/app/bench_k34.py``):
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
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


def backward_calls(c, sk, smp):
    """K5a and K5b (rgb-only) on the shape's K3 slots: K5a from a cotangent
    of rgb and the ray losses, K5b from K5a's."""
    g, p, B = c["grid"], c["pool"], c["origins"].shape[0]
    gen = torch.Generator(device=p.offsets.device).manual_seed(0)
    g_rgb = torch.randn((B, 3), generator=gen, device=p.offsets.device) / (3 * B)
    g_rl = torch.full((12, B), 0.1 / B, device=p.offsets.device)
    ta = g.truncated_vol_render_a

    def k5a():
        return kernels.backward_ray(p.offsets, smp, ta, c["opt"], g_rgb, g_rl)

    d_alpha, d_t, d_col = k5a()

    def k5b():
        return kernels.backward_entry(p.ray_id, p.l, p.close_t, p.far_t, c["origins"], c["dirs"],
                                      c["sh_mult"], g.links, c["packed"], S._surface_spec(g),
                                      g.level_set_data, c["ngt"], S._fss(g), c["opt"],
                                      sk["contrib"], d_alpha, d_t, d_col, g_rl)

    return k5a, k5b


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
    k5a, k5b = backward_calls(c, sk, smp)
    S0 = sk["n_slots"]
    return {"shape": label, "reso": list(c["grid"].reso), "rays": B, "entries": M, "slots": S0,
            "max_entries_a_ray": int((c["pool"].offsets[1:] - c["pool"].offsets[:-1]).max()),
            "check": {"phase_b": c3, "composite": c4,
                      "backward_picks": {"ok": not any(picks.values()), "rays_differ": picks}},
            "ms": {"phase_b": timed(k3, reps), "composite": timed(k4, reps),
                   "backward_ray": timed(k5a, reps), "backward_entry": timed(k5b, reps)},
            "bound": bounds(c, S0, sk["loss_e"].shape[0], typed),
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
               for k in ("phase_b", "composite", "backward_picks")):
        raise SystemExit("K3 or K4 differs from its plain version, or K5a's picks from K4's")
    return out


if __name__ == "__main__":
    main()
