"""Time K6's TV and normal kernels (``reg_tv``, ``reg_normal``) on the device
at the main path's shapes, on chip_smoke.py's shell grids
(``bench_k34.shell_grid``: bench.py's sphere shell, raw alpha in [0.5, 3],
a smooth SH field from the seed):

- ``every_512``: the every-cell mode of the recipe's surface stage
  (``tv_surface_sparsity = norm_surface_sparsity = 1``, the dense losses of
  ``train/steps.py``) at 512^3: the surface TV, normal L1 and normal L2;
- ``every_256``: the same at 256^3, the first surface stage's lattice;
- ``window_512``: bench.py's protocol, windows of 0.01 of the rows at
  512^3: TV of density, of the 27 SH channels and of the surface, and
  normal L1.

Each launch is timed on the device alone (``bench_k34.graph_ms``: a CUDA
graph of the calls, the wrapper's allocations and zero fills included)
beside two bounds: the lattice bound (every link of the lattice read once,
the rows read, the gradient written and zeroed) and the present-vertex
bound (the row coordinates, each distinct link the present vertices'
stencils touch, the rows and the gradient), both over 3.35 TB/s. With
``--profile`` it also profiles one 512^3 surface step (40,960 rays) under
the recipe's regularizer settings and one under bench.py's protocol.

    python -m alphasurf_torch.app.bench_k6 [--reps 20] [--profile]

Prints one JSON line: for each shape and launch the device ms, the loss,
the threads launched, both bounds; the device ms of the plain torch around
the TV sh launch (the wrapper's zero fill of the gradient, the autograd
backward's scaling of it); the registers and spills nvcc reported for
reg.cu's K6 kernels; the profiles; the card. Needs a card.

Another checkout's kernels are timed in the same call by running this file
from that checkout's root with the checkout on PYTHONPATH (``cd
build/parent && PYTHONPATH=$PWD python <this tree>/alphasurf_torch/app/bench_k6.py``):
parent, change, change, parent. It calls the every-cell mode with row
coordinates where that tree's ``kernels.reg_tv`` takes them.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import time

import torch

from alphasurf_torch import kernels
from alphasurf_torch.app.bench_k34 import graph_ms, shell_grid
from alphasurf_torch.losses import reg as R

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
WINDOW = 0.01  # bench.py's regularizer sparsity
STEP_BATCH = 40960
WIDTH = 800
TV_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
NORMAL_OFFSETS = tuple((a, b, c) for a in range(3) for b in range(3) for c in range(3))
# the recipe's regularizer weights (tools/recipe_run.py:133-141), beside
# bench_hparams' lambda_tv_alpha 1e-5, lambda_tv_surface 1e-3, lambda_normal_l1 1e-6
RECIPE_LAMBDAS = dict(lambda_tv_alpha=1e-5, lambda_tv_surface=1e-3, lambda_normal_l1=1e-6,
                      lambda_sparsify_alpha=1e-9)


def takes_row_coords() -> bool:
    """Whether this tree's every-cell K6 visits the present rows (it then
    takes the row coordinates)."""
    return "row_coords" in inspect.signature(kernels.reg_tv).parameters


def every_cell_calls(grid, rc) -> dict:
    """The every-cell launches of a recipe surface step, as zero-argument
    calls returning (loss, grad)."""
    L, surf, lv = grid.links, grid.surface_data.detach(), grid.level_set_data
    scale = 1.0 / L.numel()
    kw = {"row_coords": rc} if takes_row_coords() else {}
    return {
        "tv_surface": lambda: kernels.reg_tv(L, None, surf, 0, 1, None, scale, **kw),
        "normal_l1": lambda: kernels.reg_normal(L, None, surf, lv, False, False, True, scale,
                                                **kw),
        "normal_l2": lambda: kernels.reg_normal(L, None, surf, lv, False, False, False, scale,
                                                **kw),
    }


def window_calls(grid, cells) -> dict:
    """bench.py's windowed launches on ``cells``."""
    L, n = grid.links, cells.numel()
    out = {}
    for name, field, c1 in (("tv_density", "density_data", 1), ("tv_sh", "sh_data", 27),
                            ("tv_surface", "surface_data", 1)):
        data = getattr(grid, field).detach()
        out[name] = (lambda data=data, c1=c1:
                     kernels.reg_tv(L, cells, data, 0, c1, None, 1.0 / n))
    out["normal_l1"] = lambda: kernels.reg_normal(L, cells, grid.surface_data.detach(),
                                                  grid.level_set_data, False, False, True, 1.0 / n)
    return out


def distinct_links(grid, cells, offsets) -> int:
    """Distinct lattice positions the stencil ``offsets`` of ``cells`` (flat
    ids, int64) touches inside the lattice."""
    X, Y, Z = grid.reso
    x, y, z = cells // (Y * Z), (cells // Z) % Y, cells % Z
    pos = []
    for a, b, c in offsets:
        ok = (x + a < X) & (y + b < Y) & (z + c < Z)
        pos.append((((x + a) * Y + y + b) * Z + z + c)[ok])
    return int(torch.unique(torch.cat(pos)).numel())


def present_cells(grid) -> torch.Tensor:
    """Flat ids (int64) of the lattice cells whose link is present."""
    return torch.nonzero(grid.links.reshape(-1) >= 0)[:, 0]


def interior(grid, cells) -> torch.Tensor:
    X, Y, Z = grid.reso
    x, y, z = cells // (Y * Z), (cells // Z) % Y, cells % Z
    return cells[(x <= X - 3) & (y <= Y - 3) & (z <= Z - 3)]


def every_cell_bounds(grid, C: int = 1) -> dict:
    """Bounds (ms) of the every-cell TV and normal: over the lattice (every
    link read once) and over the present vertices (row coordinates, the
    distinct links of their stencils); both with the rows read and the
    gradient written and zeroed (3 passes over the capacity's C floats)."""
    cap, N = grid.capacity, grid.links.numel()
    rows = 3 * cap * C * 4
    pres = present_cells(grid)
    out = {"lattice": (N * 4 + rows) / HBM_BYTES_PER_S * 1e3}
    for name, offs, cells in (("tv", TV_OFFSETS, pres), ("normal", NORMAL_OFFSETS,
                                                          interior(grid, pres))):
        b = cap * 12 + distinct_links(grid, cells, offs) * 4 + rows
        out[f"present_{name}"] = b / HBM_BYTES_PER_S * 1e3
    return out


def window_bound(grid, cells, offsets, C: int) -> float:
    """Bound (ms) of a windowed launch: the cell ids, each distinct link its
    stencil touches, the rows those name read and their gradient added, and
    the gradient array zeroed."""
    c = cells.long()
    d = distinct_links(grid, c, offsets)
    return (c.numel() * 4 + d * 4 + d * C * 4 * 2 + grid.capacity * C * 4) / HBM_BYTES_PER_S * 1e3


def threads(name: str, mode: str, grid, n_cells: int) -> int:
    """Threads the launch starts in this tree's design."""
    X, Y, Z = grid.reso
    if mode == "every":
        if takes_row_coords():
            return grid.capacity
        return X * Y * Z if name.startswith("tv") else (X - 2) * (Y - 2) * (Z - 2)
    return n_cells * (32 if name == "tv_sh" and takes_row_coords() else 1)


def time_calls(calls: dict, reps: int) -> dict:
    out = {}
    for name, fn in calls.items():
        loss, _ = fn()
        out[name] = {"device_ms": graph_ms(fn, reps), "loss": float(loss)}
    return out


def registers() -> dict:
    """Registers and spills nvcc reports for reg.cu's K6 kernels (from this
    process's build, or from a build of reg.cu alone into a scratch file
    under build/ when the library was built before it)."""
    lines = kernels.BUILD_LOG.get("reg", {}).get("ptxas")
    if lines is None:
        out_so = kernels.BUILD_DIR / f"reg_ptxas.{os.getpid()}.tmp"
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        text = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_so),
                               str(kernels.CSRC / "reg.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True).stdout
        out_so.unlink(missing_ok=True)
        lines = [ln for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
    out, name = {}, None
    for ln in lines:
        if "entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
        elif name and any(k in name for k in ("reg_tv", "reg_normal")):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def surface_step(grid, rc, device, recipe: bool):
    """One 512^3 surface step of STEP_BATCH rays as a zero-argument call:
    the recipe's regularizer settings (every-cell TV and normal) or bench.py's
    protocol (windows of 0.01)."""
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render.surface import occupancy_words
    from alphasurf_torch.train.steps import StepConfig, init_rms, make_surface_step

    opt = bench_step.bench_options()
    rays = bench_step.bench_rays(WIDTH, device)
    s = int(WIDTH * WIDTH * 0.35)
    r = Rays(rays.origins[s:s + STEP_BATCH], rays.dirs[s:s + STEP_BATCH])
    extra = dict(tv_surface_sparsity=1.0, norm_surface_sparsity=1.0) if recipe else {}
    step = make_surface_step(StepConfig(opt=opt, cache_size=None, **extra))
    hp = bench_step.bench_hparams()
    if recipe:
        hp = hp._replace(**RECIPE_LAMBDAS)
    rms, gen = init_rms(grid), torch.Generator().manual_seed(0)
    gt = torch.full((STEP_BATCH, 3), 0.5, device=device)
    occ = occupancy_words(grid, opt)
    return lambda: step(grid, rms, r, gt, hp, gen, occ=occ, row_coords=rc)


def profile_device(fn, top: int = 14) -> dict:
    """torch.profiler over one warm fn() call: wall and device-busy ms, the
    idle share and the largest device items (ms, count, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1.0 - busy / wall,
            "top": [[round(ms, 4), n, key[:90]] for ms, n, key in rows[:top]]}


def run(reps: int = 20, seed: int = 0, profile: bool = False) -> dict:
    dev = torch.device("cuda")
    kernels.build()
    out = {"reps": reps, "package": kernels.__file__, "present_vertex_mode": takes_row_coords(),
           "shapes": {}}
    for reso in (512, 256):
        grid, rc = shell_grid(reso, dev, seed)
        label = f"every_{reso}"
        case = {"capacity": grid.capacity, "lattice": grid.links.numel(),
                "bounds": every_cell_bounds(grid), "ms": time_calls(every_cell_calls(grid, rc), reps)}
        for name, v in case["ms"].items():
            v["threads"] = threads(name, "every", grid, 0)
        out["shapes"][label] = case
        if reso == 512:
            gen = torch.Generator().manual_seed(seed)
            cells = R.sample_present_cells(gen, grid, rc, WINDOW)
            ms = time_calls(window_calls(grid, cells), reps)
            for name, v in ms.items():
                offs, C = ((NORMAL_OFFSETS, 1) if name.startswith("normal") else
                           (TV_OFFSETS, 27 if name == "tv_sh" else 1))
                v["bound_ms"] = window_bound(grid, cells, offs, C)
                v["threads"] = threads(name, "window", grid, cells.numel())
            out["shapes"]["window_512"] = {"cells": cells.numel(), "ms": ms}
            # the plain torch around the TV sh launch: the wrapper's zero
            # fill of its (rows, 27) gradient and _KernelLoss.backward's g * x
            sh = grid.sh_data.detach()
            _, g_sh = window_calls(grid, cells)["tv_sh"]()
            cot = torch.ones((), device=dev)
            out["plain_around_tv_sh"] = {
                "bytes": sh.numel() * 4, "zeros_like_ms": graph_ms(lambda: torch.zeros_like(sh), reps),
                "backward_scale_ms": graph_ms(lambda: cot * g_sh, reps)}
            if profile:
                out["profile"] = {
                    "recipe_step": profile_device(surface_step(grid, rc, dev, recipe=True)),
                    "bench_step": profile_device(surface_step(grid, rc, dev, recipe=False)),
                }
        del grid, rc
        torch.cuda.empty_cache()
    out["registers"] = registers()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k6 needs a CUDA card")
    out = run(a.reps, a.seed, a.profile)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
