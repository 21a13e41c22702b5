"""Throughput of a train step: rays per second through the fused forward,
backward and RMSprop, under the protocol of the repository's ``bench.py``
(BASELINE.md).

    python -m alphasurf_torch.app.bench_step [--stage surface|cuvol] [--reso R] [--batch 40960]
        [--renderer packed|compact|dense] [--basis sh|texture|mlp]

``--stage surface`` (the default, reso 512) is the surface step on
bench.py's sphere shell: the analytic SDF of a sphere of radius reso/4,
kept where |sdf| < 3 voxels and dilated twice over the 26 neighbours,
density 0.5, SH 0, fake_sample_std 0.1, rows in flat order, built on the
device, under bench.py's render options and weights, through the renderer
``--renderer`` names (bench.py's ``argv[2]``; compact at its default K of
64 and voxel chunk of 8, dense at its full walk). ``--stage cuvol``
(reso 256) is the Plenoxels warm-start step on the warm start's own
starting grid, ``create_grid(reso, use_sphere_bound=True, init_sigma=0.1,
basis_dim=9)``, under the Config defaults' render options and its
learning rates and TV weights (lr_sigma 3e1, lr_sh 1e-2, lambda_tv 1e-5,
lambda_tv_sh 1e-3), through the packed cuvol renderer (K8 over K2's pool)
or, with ``--renderer compact`` or ``dense``, the dense march (K10 and
its backward), as the JAX step does for a renderer that is not packed.

``--basis texture`` gives either grid a learned 3D-texture basis
(``reinit_learned_bases(32, 9, "sh")``), ``--basis mlp`` the learned MLP
(``init_basis_mlp`` at its defaults: posenc degree 4, hidden 64, drawn
from ``--seed``); both then train at lr_basis 1e-2 with lambda_tv_basis
1e-2 (the JAX package's tests/test_steps_ext.py values), and the output
counts the basis's moved rows (``basis_moved``).

Both: rays of the 800x800 camera at pose_spherical(30, 20, 2.7) with
fx = 1.1 W; batches of ``batch`` consecutive rays cycle over rows 35-65% of
the image, where the sphere is, against a target of 0.5; regularizer
windows over present rows. The occupancy (none for the dense march) is
refreshed every 16 steps. One
warm-up step must render geometry (loss < 0.24; an empty batch scores
0.25); then ``steps`` timed steps. Prints one JSON line and returns it as a
dict.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.nn.functional as F

from .. import defs
from ..core.device import resolve_device
from ..core.grid import SparseGrid, create_grid
from ..core.options import RenderOptions
from ..core.sh import init_basis_mlp, reinit_learned_bases
from ..core.rays import Camera, Rays
from ..data.synthetic import pose_spherical
from ..losses.reg import row_coords_of
from ..render.cuvol import density_occupancy_words
from ..render.surface import occupancy_words
from ..train.steps import HParams, StepConfig, init_rms, make_cuvol_step, make_surface_step

STAGES = ("surface", "cuvol")
DEFAULT_RESO = {"surface": 512, "cuvol": 256}
BASES = ("sh", "texture", "mlp")
BASIS_RESO = 32  # the learned texture's resolution
BASIS_HP = dict(lr_basis=1e-2, lambda_tv_basis=1e-2)


def bench_options() -> RenderOptions:
    """bench.py's render options."""
    return RenderOptions(sigma_thresh=-1e9, stop_thresh=1e-7, only_outward_intersect=True,
                         surf_fake_sample=True, limited_fake_sample=True,
                         truncated_vol_render=True)


def bench_hparams() -> HParams:
    """bench.py's learning rates and loss weights."""
    return HParams(lr_alpha=1e-3, lr_surface=1e-5, lr_sh=1e-3, lambda_tv_alpha=1e-5,
                   lambda_tv_surface=1e-3, lambda_normal_l1=1e-6, lambda_l_entropy=1e-4)


def cuvol_options() -> RenderOptions:
    """The Config defaults' render options of the warm start
    (``render_options_from(Config(), no_surface=True)``)."""
    from .config import Config, render_options_from

    return render_options_from(Config(), no_surface=True)


def cuvol_hparams() -> HParams:
    """The Config defaults' warm-start learning rates and TV weights
    (config.py:87, 104, 139, 142)."""
    return HParams(lr_sigma=3e1, lr_sh=1e-2, lambda_tv=1e-5, lambda_tv_sh=1e-3)


def with_basis(grid: SparseGrid, basis: str, seed: int = 0) -> SparseGrid:
    """``grid`` with the learned basis ``basis`` ("sh": unchanged): the 3D
    texture initialised with the SH basis at BASIS_RESO, or the MLP at
    ``init_basis_mlp``'s defaults drawn from ``seed``."""
    if basis not in BASES:
        raise ValueError(f"basis must be one of {BASES}, not {basis!r}")
    dev, bd = grid.links.device, grid.basis_dim
    if basis == "texture":
        return grid.replace(basis_type=defs.BASIS_TYPE_3D_TEXTURE,
                            basis_data=reinit_learned_bases(BASIS_RESO, bd, "sh", device=dev))
    if basis == "mlp":
        mlp = init_basis_mlp(torch.Generator().manual_seed(seed), bd, device=dev)
        return grid.replace(basis_type=defs.BASIS_TYPE_MLP, basis_mlp=mlp)
    return grid


def build_cuvol_grid(reso: int, device, basis: str = "sh") -> tuple[SparseGrid, torch.Tensor]:
    """The warm start's starting grid on ``device`` and its row coords."""
    grid = create_grid(reso, use_sphere_bound=True, init_sigma=0.1, basis_dim=9, device=device)
    return with_basis(grid, basis), row_coords_of(grid)


def build_bench_grid(reso: int, device, basis: str = "sh") -> tuple[SparseGrid, torch.Tensor]:
    """bench.py's shell grid on ``device`` and its row coords (capacity, 3),
    with the learned basis ``basis`` (``with_basis``)."""
    dev = resolve_device(device)
    idx = torch.arange(reso, dtype=torch.float32, device=dev)
    r = torch.sqrt((idx[:, None, None] - reso / 2) ** 2 + (idx[None, :, None] - reso / 2) ** 2
                   + (idx[None, None, :] - reso / 2) ** 2)
    sdf = (reso / 4.0 - r) / (reso / 4.0)
    del r
    keep = (torch.abs(sdf) < 3.0 / (reso / 4.0)).float()[None, None]
    for _ in range(2):  # 26-neighbourhood dilation, twice
        keep = F.max_pool3d(keep, 3, 1, 1)
    flat = keep.reshape(-1) > 0
    del keep
    links = torch.where(flat, torch.cumsum(flat.int(), 0, dtype=torch.int32) - 1,
                        torch.full_like(flat, -1, dtype=torch.int32))
    occ_idx = torch.nonzero(flat)[:, 0]
    cap = occ_idx.numel()
    row_coords = torch.stack([occ_idx // (reso * reso), (occ_idx // reso) % reso, occ_idx % reso],
                             -1).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    grid = SparseGrid(
        links=links.reshape(reso, reso, reso), density_data=torch.full((cap, 1), 0.5, **f32),
        sh_data=torch.zeros((cap, 27), **f32),
        surface_data=sdf.reshape(-1)[occ_idx][:, None].contiguous(),
        level_set_data=torch.zeros(1, **f32), fake_sample_std=torch.full((1, 1), 0.1, **f32),
        truncated_vol_render_a=torch.tensor(1.0, **f32), radius=torch.ones(3, **f32),
        center=torch.zeros(3, **f32), basis_dim=9, surface_type=defs.SURFACE_TYPE_SDF,
    )
    return with_basis(grid, basis), row_coords


def bench_rays(width: int, device) -> Rays:
    """All rays of bench.py's width x width camera, made on the device."""
    cam = Camera.make(pose_spherical(30.0, 20.0, 2.7), fx=1.1 * width, width=width, height=width)
    return cam.gen_rays_device(device)


def _basis_rows(grid: SparseGrid):
    """The learned basis's rows, flattened: None for SH."""
    if grid.basis_data is not None:
        return grid.basis_data.detach().reshape(-1, grid.basis_data.shape[-1]).clone()
    if grid.basis_mlp is not None:
        return torch.cat([v.detach().reshape(-1, 1) for v in grid.basis_mlp.tensors().values()])
    return None


def run(reso: int | None = None, batch: int = 40960, steps: int = 33, width: int = 800,
        device="cuda", seed: int = 0, stage: str = "surface", renderer: str = "packed",
        basis: str = "sh") -> dict:
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, not {stage!r}")
    reso = DEFAULT_RESO[stage] if reso is None else reso
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if stage == "surface":
        grid, row_coords = build_bench_grid(reso, dev, basis)
        opt, hp = bench_options(), bench_hparams()
        step = make_surface_step(StepConfig(opt=opt, cache_size=None, renderer=renderer))

        def occupancy(g):
            return occupancy_words(g, opt)
    else:
        grid, row_coords = build_cuvol_grid(reso, dev, basis)
        opt, hp = cuvol_options(), cuvol_hparams()
        step = make_cuvol_step(StepConfig(opt=opt, renderer=renderer))

        def occupancy(g):  # the dense march takes none
            return density_occupancy_words(g) if renderer == "packed" else None
    if basis != "sh":
        hp = hp._replace(**BASIS_HP)
    init = {"density": float(grid.density_data[0, 0]), "sh": 0.0}
    basis0 = _basis_rows(grid)
    rays = bench_rays(width, dev)
    rms = init_rms(grid)
    gen = torch.Generator().manual_seed(seed)
    gt = torch.full((batch, 3), 0.5, dtype=torch.float32, device=dev)
    n = rays.origins.shape[0]
    lo = int(n * 0.35)
    span = max(int(n * 0.30) - batch, 1)
    state = {"occ": occupancy(grid), "grid": grid, "rms": rms}
    setup = time.perf_counter() - t0

    def run_batch(i):
        if i > 0 and i % 16 == 0:
            state["occ"] = occupancy(state["grid"])
        s = lo + (i * batch) % span
        r = Rays(rays.origins[s:s + batch], rays.dirs[s:s + batch])
        state["grid"], state["rms"], stats = step(state["grid"], state["rms"], r, gt, hp, gen,
                                                  occ=state["occ"], row_coords=row_coords)
        return stats

    first = float(run_batch(0)["loss"])
    if not first < 0.24:
        raise AssertionError(f"the first bench batch renders no geometry (loss {first}); the "
                             "batch window must cover sphere-bearing rows")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses = [run_batch(i)["loss"] for i in range(steps)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    g = state["grid"]
    moved = int(((g.density_data != init["density"]).any(dim=1)
                 | (g.sh_data != init["sh"]).any(dim=1)).sum())
    basis_moved = None if basis0 is None else int((_basis_rows(g) != basis0).any(dim=1).sum())
    return {
        "metric": "rays_per_s_fwd_bwd",
        "rays_per_s_fwd_bwd": steps * batch / seconds,
        "stage": stage,
        "renderer": renderer,
        "basis": basis,
        "batch": batch,
        "reso": reso,
        "capacity": grid.capacity,
        "steps": steps,
        "seconds": seconds,
        "setup_seconds": setup,
        "first_loss": first,
        "last_loss": losses[-1],
        "losses_finite": all(math.isfinite(x) for x in losses),
        "rows_moved": moved,
        "basis_moved": basis_moved,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=STAGES, default="surface")
    ap.add_argument("--reso", type=int, default=None,
                    help="grid resolution (default 512 for surface, 256 for cuvol)")
    ap.add_argument("--batch", type=int, default=40960)
    ap.add_argument("--steps", type=int, default=33)
    ap.add_argument("--width", type=int, default=800, help="image width and height")
    ap.add_argument("--seed", type=int, default=0, help="seed of the regularizer windows")
    ap.add_argument("--renderer", choices=("packed", "compact", "dense"), default="packed",
                    help="the step's renderer (bench.py's argv[2]); a cuvol step that is not "
                         "packed trains through the dense march")
    ap.add_argument("--basis", choices=BASES, default="sh",
                    help="the colour basis: SH, or a learned 3D texture or MLP")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run(a.reso, a.batch, a.steps, a.width, a.device, a.seed, a.stage, a.renderer, a.basis)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
