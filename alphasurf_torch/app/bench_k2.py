"""Time K2, phase A's count and fill, at the main path's three shapes: the
serving chunk (the 16,384 central rays of render_circle's first 800x800
frame of bench.py's 512^3 shell grid, bench.py's render options), the warm
step's batch (``app/bench_k8.warm_case``: 40,960 rays at 256^3 over K1d's
words) and the surface step's batch (bench_step's first 40,960-ray batch at
512^3); and K1 and K1d, the occupancy words K2 reads.

    python -m alphasurf_torch.app.bench_k2 [--reps 20] [--part k1|k2|all]

K2 (``--part k2``): at each shape the pool is first held against the plain
version, element for element in pool order and after a (ray, t, l) sort.
The JSON line holds for each shape the rays, candidates, entries, the
count's and the fill's milliseconds by CUDA events (and K11b's capped fill
at K = 64 on the serving chunk) and the bounds by chip_smoke.py's formula.

K1 and K1d (``--part k1``): the words held equal to the plain version's,
then timed on the device (``bench_k34.graph_ms``, a CUDA graph of the calls)
and per call as the host issues them (``time_ms``), at the 512^3 shell under
bench.py's and render_circle's options, the 256^3 (the recipe's first
surface stage) and 128^3 shells, one 256^3 grid of each other surface type
(chip_smoke.py's ``type_grid`` under its ``type_options``) and, for K1d,
the warm start's 256^3 blobby grid (chip_smoke.py's ``blobby_cuvol_grid``);
each with its bound by chip_smoke.py's formula (the links, the density
rows, the surface rows under the hull test and the words, once).

Both parts print the registers nvcc reported and the card, in one JSON
line. Needs a card, and chip_smoke.py importable (run from the repository
root). Another checkout's kernels are timed in the same call by running
this file from that checkout's root with the checkout on PYTHONPATH
(``PYTHONPATH=$PWD python .../bench_k2.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from alphasurf_torch import defs, kernels
from alphasurf_torch.app.bench_k8 import FP32_OPS_PER_S, HBM_BYTES_PER_S, WIDTH, time_ms, warm_case
from alphasurf_torch.app.bench_step import bench_options, bench_rays, build_bench_grid
from alphasurf_torch.core.rays import Camera, Rays
from alphasurf_torch.data.synthetic import pose_spherical
from alphasurf_torch.ops import dda
from alphasurf_torch.render import cuvol as C
from alphasurf_torch.render import surface as S

CHUNK = 16384  # render_image's chunk
BATCH = 40960  # bench_step's batch
COMPACT_K = 64  # StepConfig.max_intersect_voxels and render_image's default


def surface_inputs(grid, rays):
    """K2's (origins, dirs, tn, tx) of a chunk of the surface renderer, as
    volume_render_surface_packed prepares them under bench.py's options."""
    origins, dirs, _, tnear, tmax, _, ray_ok, _ = S._prep(grid, rays, bench_options())
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    return tuple(x.contiguous() for x in (origins, dirs, tn, tx))


def serve_rays(device) -> Rays:
    """The chunk of CHUNK central rays of render_circle's first frame (of
    two) at WIDTH x WIDTH, where the sphere is in view."""
    cam = Camera.make(pose_spherical(0.0, 30.0, 2.7), fx=1.2 * WIDTH, width=WIDTH, height=WIDTH)
    rays = cam.gen_rays_device(device)
    s = (WIDTH * WIDTH) // 2 - CHUNK // 2
    return Rays(rays.origins[s:s + CHUNK].contiguous(), rays.dirs[s:s + CHUNK].contiguous())


def step_rays(device, batch: int = BATCH) -> Rays:
    """bench_step's first batch: rays [0.35 n, 0.35 n + batch) of its camera."""
    rays = bench_rays(WIDTH, device)
    s = int(rays.origins.shape[0] * 0.35)
    return Rays(rays.origins[s:s + batch].contiguous(), rays.dirs[s:s + batch].contiguous())


def warm_inputs(grid, ray_t):
    """K2's (origins, dirs, tn, tx) of a warm-step chunk's rays (``ray_t``,
    cuvol._prep's), as render/cuvol.py:cuvol_pool bounds them (written out
    here, so that the script runs on a checkout as it is)."""
    origins, dirs, tmin, tmax = ray_t[0], ray_t[1], ray_t[4], ray_t[5]
    tnear_v, tmax_v = dda.ray_bounds(grid, origins, dirs)
    tnear, tmaxp = torch.maximum(tnear_v, tmin), torch.minimum(tmax_v, tmax)
    ok = torch.isfinite(tnear) & torch.isfinite(tmaxp) & (tnear <= tmaxp)
    tn, tx = S._phase_a_bounds(tnear, tmaxp, ok)
    return tuple(x.contiguous() for x in (origins, dirs, tn, tx))


def n_candidates(reso, origins, dirs, tn, tx) -> int:
    """Candidates these rays visit: the entry plus each interior plane
    crossed in (tnear, tmax)."""
    n = origins.shape[0]
    for ax in range(3):
        p0 = origins[:, ax] + tn * dirs[:, ax]
        p1 = origins[:, ax] + torch.maximum(tx, tn) * dirs[:, ax]
        lo = torch.clamp(torch.floor(torch.minimum(p0, p1)) + 1, min=1)
        hi = torch.clamp(torch.ceil(torch.maximum(p0, p1)) - 1, max=reso[ax] - 2)
        n += int(torch.clamp(hi - lo + 1, min=0).sum())
    return n


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k2_bounds(B: int, M: int, n_words: int, n_cand: int, M_cap: int | None = None) -> dict:
    """chip_smoke.py's bounds: the rays and the words in, the counts or the
    pool (and its offsets) out, ~30 float operations a candidate."""
    ray_bytes = B * 8 * 4 + n_words * 4
    out = {"count": bound_ms(ray_bytes + B * 8, n_cand * 30),
           "fill": bound_ms(ray_bytes + (B + 1) * 8 + M * 24, n_cand * 30)}
    if M_cap is not None:
        out["compact_fill"] = bound_ms(ray_bytes + (B + 1) * 8 + M_cap * 24, n_cand * 30)
    return out


def kernel_pool(reso, origins, dirs, tn, tx, words) -> S.Pool:
    """K2 through its wrappers: count, scan, fill."""
    n_occ, n_valid = kernels.phase_a_count(origins, dirs, tn, tx, words, reso)
    offsets = torch.zeros(origins.shape[0] + 1, dtype=torch.int64, device=origins.device)
    torch.cumsum(n_valid, 0, out=offsets[1:])
    pool = kernels.phase_a_fill(origins, dirs, tn, tx, words, reso, offsets, int(offsets[-1]))
    return S.Pool(*pool, offsets, n_occ)


def sorted_pool(ray_id, l, close_t, far_t):
    """The pool's arrays on the host, ordered by (ray, t, l)."""
    r, lv, c, f = (x.cpu().numpy() for x in (ray_id, l, close_t, far_t))
    key = np.lexsort((lv[:, 2], lv[:, 1], lv[:, 0], c, r))
    return r[key], lv[key], c[key], f[key]


def compare_pools(got: S.Pool, ref: S.Pool) -> dict:
    """Which parts of two pools are equal: the four arrays element for
    element in pool order, the same after a (ray, t, l) sort (sorted only
    when the order differs: equal arrays sort equally), the offsets and
    n_occupied; and where the first entry out of order lies."""
    same_m = got.close_t.shape == ref.close_t.shape
    in_order = same_m and all(torch.equal(a, b) for a, b in zip(got[:4], ref[:4]))
    first, same_sorted = None, in_order
    if same_m and not in_order:
        bad = torch.zeros(got.close_t.shape[0], dtype=torch.bool, device=got.close_t.device)
        for a, b in zip(got[:4], ref[:4]):
            bad |= (a != b).reshape(a.shape[0], -1).any(1)
        first = int(bad.nonzero()[0, 0])
        same_sorted = all(np.array_equal(a, b) for a, b in
                          zip(sorted_pool(*got[:4]), sorted_pool(*ref[:4])))
    return {
        "in_order": in_order,
        "sorted": same_sorted,
        "offsets": torch.equal(got.offsets, ref.offsets),
        "n_occupied": torch.equal(got.n_occupied, ref.n_occupied),
        "first_out_of_order": first,
    }


def time_k2(reso, inputs, words, pool: S.Pool, reps: int, caps=None) -> dict:
    """Milliseconds of the count, the fill and, with offsets caps, K11b's
    fill."""
    offsets, M = pool.offsets, pool.close_t.shape[0]
    out = {"count": time_ms(lambda: kernels.phase_a_count(*inputs, words, reso), reps),
           "fill": time_ms(lambda: kernels.phase_a_fill(*inputs, words, reso, offsets, M), reps)}
    if caps is not None:
        Mc = int(caps[-1])
        out["compact_fill"] = time_ms(
            lambda: kernels.compact_fill(*inputs, words, reso, caps, Mc), reps)
    return out


def cap_offsets(pool: S.Pool, K: int) -> torch.Tensor:
    """K11b's offsets: the scan of min(n_entries, K)."""
    n = pool.offsets[1:] - pool.offsets[:-1]
    out = torch.zeros_like(pool.offsets)
    torch.cumsum(torch.clamp(n, max=K), 0, out=out[1:])
    return out


def registers(source: str = "phase_a", keys=("phase_a",)) -> dict:
    """The registers and spills nvcc reported for ``source``'s kernels whose
    names hold one of ``keys`` (from this process's build, or from a build
    of that source alone into a scratch file under build/ when the library
    was built before it)."""
    lines = kernels.BUILD_LOG.get(source, {}).get("ptxas")
    if lines is None:
        out_so = kernels.BUILD_DIR / f"{source}_ptxas.{os.getpid()}.tmp"
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        text = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_so),
                               str(kernels.CSRC / f"{source}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True).stdout
        out_so.unlink(missing_ok=True)
        lines = [ln for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
    out, name = {}, None
    for ln in lines:
        if "entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
        elif name and any(k in name for k in keys):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def shape_case(label: str, grid, inputs, words, reps: int, with_cap: bool) -> dict:
    """One shape: the pool against the plain version, then timed."""
    reso = grid.reso
    pool = kernel_pool(reso, *inputs, words)
    ref = S._compact_crossings_plain(reso, *inputs, words)
    same = compare_pools(pool, ref)
    del ref
    B, M = inputs[0].shape[0], pool.close_t.shape[0]
    n_cand = n_candidates(reso, *inputs)
    caps = cap_offsets(pool, COMPACT_K) if with_cap else None
    return {
        "shape": label, "reso": list(reso), "rays": B, "candidates": n_cand, "entries": M,
        "equal": same,
        "ms": time_k2(reso, inputs, words, pool, reps, caps),
        "bound": k2_bounds(B, M, words.numel(), n_cand,
                           int(caps[-1]) if caps is not None else None),
    }


def k1_args(grid, opt) -> tuple:
    """K1's wrapper arguments as render/surface.occupancy_words passes them."""
    sigma_thresh, hull = S._candidate_test(grid, opt, False)
    if grid.surface_type == defs.SURFACE_TYPE_UDF_ALPHA:
        density = torch.amax(grid.density_data.detach()).reshape(1)
    else:
        density = grid.density_data.detach()[:, 0].contiguous()
    return (grid.links, density, grid.surface_data.detach().contiguous(), grid.level_set_data,
            sigma_thresh, hull, grid.surface_type)


def occupancy_bound(grid, n_dens: int, n_surf: int, n_words: int) -> tuple[float, str]:
    """chip_smoke.py's bound of K1 and K1d: the links, ``n_dens`` density
    and ``n_surf`` surface values and the words, each once, as bytes; about
    40 operations a voxel (its corners' max, min and max)."""
    X, Y, Z = grid.reso
    return bound_ms((grid.links.numel() + n_dens + n_surf + n_words) * 4,
                    (X - 1) * (Y - 1) * (Z - 1) * 40)


def occupancy_case(label: str, fn, plain, grid, n_dens: int, n_surf: int, reps: int) -> dict:
    """One K1 or K1d shape: the words against the plain version, then the
    device and per-call times beside the bound."""
    from alphasurf_torch.app.bench_k34 import graph_ms

    words = fn()
    ref = plain()
    equal = torch.equal(words, ref)
    del ref
    b = occupancy_bound(grid, n_dens, n_surf, words.numel())
    out = {"shape": label, "reso": list(grid.reso), "capacity": grid.capacity,
           "occupied": int(S.unpack_occupancy_bits(words, grid.reso[2] - 1).sum()),
           "equal": equal, "device_ms": graph_ms(fn, reps), "call_ms": time_ms(fn, reps),
           "bound_ms": b[0], "bound_by": b[1]}
    print(json.dumps(out), flush=True)
    return out


def k1_cases(dev, reps: int, seed: int) -> list:
    """K1 at the shells and each type's grid, K1d at the warm start's grid."""
    import chip_smoke
    from alphasurf_torch.app.bench_k34 import shell_grid
    from alphasurf_torch.app.render_circle import circle_render_options

    cases = []

    def k1_case(label, grid, opt):
        args = k1_args(grid, opt)
        n_dens = 1 if args[1].shape[0] == 1 and grid.capacity > 1 else grid.capacity
        cases.append(occupancy_case(
            label, lambda: kernels.occupancy(*args), lambda: S._occupancy_words_plain(grid, opt),
            grid, n_dens, grid.capacity if args[5] else 0, reps))

    for reso in (512, 256, 128):
        grid, _ = shell_grid(reso, dev, seed)
        k1_case(f"shell {reso} serve", grid, circle_render_options())
        if reso == 512:
            k1_case("shell 512 bench", grid, bench_options())
        del grid
        torch.cuda.empty_cache()
    for name in chip_smoke.SURFACE_TYPES:
        grid = chip_smoke.type_grid(name, dev, seed)
        k1_case(f"{name} 256", grid, chip_smoke.type_options(name))
        del grid
        torch.cuda.empty_cache()
    grid, _ = chip_smoke.blobby_cuvol_grid(256, dev, seed)
    dens = grid.density_data.detach()[:, 0].contiguous()
    cases.append(occupancy_case(
        "warm 256 (K1d)", lambda: kernels.density_occupancy(grid.links, dens),
        lambda: S.pack_occupancy_bits(C._density_occupancy_plain(grid)), grid, grid.capacity, 0,
        reps))
    return cases


def k2_cases(dev, reps: int, seed: int) -> list:
    cases = []
    grid, _ = build_bench_grid(512, dev)
    words = S.occupancy_words(grid, bench_options())
    cases.append(shape_case("serve", grid, surface_inputs(grid, serve_rays(dev)), words, reps,
                            True))
    cases.append(shape_case("surface", grid, surface_inputs(grid, step_rays(dev)), words, reps,
                            False))
    del grid, words
    torch.cuda.empty_cache()
    grid, _, chunk = warm_case(256, BATCH, dev, seed)
    words = C.density_occupancy_words(grid)
    cases.append(shape_case("warm", grid, warm_inputs(grid, chunk.rays), words, reps, False))
    return cases


def run(reps: int = 20, seed: int = 0, part: str = "all") -> dict:
    dev = torch.device("cuda")
    kernels.build()
    out = {"reps": reps, "package": kernels.__file__}
    if part in ("k2", "all"):
        out["cases"] = k2_cases(dev, reps, seed)
        out["registers"] = registers()
    if part in ("k1", "all"):
        out["k1_cases"] = k1_cases(dev, reps, seed)
        out["k1_registers"] = registers("occupancy", ("occupancy",))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", choices=("k1", "k2", "all"), default="all")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2 needs a CUDA card")
    out = run(a.reps, a.seed, a.part)
    print(json.dumps(out), flush=True)
    if not all(c["equal"]["in_order"] and c["equal"]["offsets"] and c["equal"]["n_occupied"]
               for c in out.get("cases", [])):
        raise SystemExit("K2's pool differs from the plain version")
    if not all(c["equal"] for c in out.get("k1_cases", [])):
        raise SystemExit("K1 or K1d words differ from the plain version")
    return out


if __name__ == "__main__":
    main()
