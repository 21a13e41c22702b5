"""How far the surface stage's learning rate moves the warm-started SDF.

Runs the pipeline's first two stages (``app/pipeline.py``) on the synthetic
data: the Plenoxels stage once per resolution, then the surface stage once
for each surface init and each (constant) surface learning rate. For every
surface step it records how far the step moved the SDF rows, in voxel
widths: after the metric rescale of the init the SDF is a world distance
(mean gradient norm 1), so a row that moves by d shifts its zero crossing
by about d / h, h the world size of a voxel (``core.topology.grid_h``).
The eval PSNR is taken right after the init and after the last step.

The rates are the JAX pipeline's (1e-2) and the recipe's 256³ rate
(1e-5, tools/recipe_run.py:126).

Usage: python -m alphasurf_torch.app.lr_probe --out_dir DIR [--resos 256]
           [--device cuda]
Prints one JSON line per variant and returns their list.
"""
from __future__ import annotations

import argparse
import json
import shutil
from os import path

INITS = ("weight", "density")
LRS = (1e-2, 1e-5)


def _record_moves(trainer, h: float, moves: list):
    """Wrap the Trainer's steps so that each surface step appends, for the
    SDF rows it moved: their count, the mean and the largest move in voxel
    widths, and the share of them that moved by more than a voxel."""
    get_step = trainer._get_step

    def wrapped_get_step(kind, no_surface):
        fn = get_step(kind, no_surface)

        def step(grid, rms, *args, **kwargs):
            before = None if grid.surface_data is None else grid.surface_data.detach().clone()
            out = fn(grid, rms, *args, **kwargs)
            after = out[0].surface_data
            if before is not None and after is not None and after.shape == before.shape:
                d = (after.detach() - before).abs()[:, 0] / h
                moved = d[d > 0]
                n = int(moved.numel())
                moves.append(dict(
                    rows=n, mean=float(moved.mean()) if n else 0.0,
                    max=float(moved.max()) if n else 0.0,
                    over_voxel=float((moved > 1.0).float().mean()) if n else 0.0))
            return out

        return step

    trainer._get_step = wrapped_get_step


def probe(out_dir: str, resos=(256,), n_train_images: int = 20, image_size: int = 800,
          n_iters_plenoxels: int = 100, n_iters_surface: int = 100, batch_size: int = 8192,
          device="cuda") -> list:
    import torch

    from ..core.device import resolve_device
    from ..core.topology import grid_h
    from ..train.trainer import Trainer
    from .pipeline import plenoxels_config, surface_config, synthetic_datasets

    device = resolve_device(device)
    rows = []
    for reso in resos:
        dset_train, dset_test = synthetic_datasets("", reso, n_train_images, 2, image_size,
                                                   device)
        plen_dir = path.join(out_dir, f"plenoxels_{reso}")
        psnr_plen = Trainer(plenoxels_config(plen_dir, reso, batch_size, n_iters_plenoxels),
                            dset_train, dset_test, device=device).train()
        for init in INITS:
            for lr in LRS:
                surf_dir = path.join(out_dir, f"surface_{reso}_{init}_{lr:g}")
                cfg = surface_config(surf_dir, plen_dir, reso, batch_size, n_iters_surface)
                cfg.surf_init_type, cfg.lr_surface, cfg.lr_surface_final = init, lr, lr
                tr = Trainer(cfg, dset_train, dset_test, device=device)
                tr.maybe_init_surface()
                h = grid_h(tr.grid)
                psnr_init = tr.eval_step()
                moves = []
                _record_moves(tr, h, moves)
                psnr = tr.train()
                n = max(len(moves), 1)
                row = dict(
                    reso=reso, init=init, lr=lr, voxel=h, capacity=int(tr.grid.capacity),
                    psnr_plenoxels=psnr_plen, psnr_init=psnr_init, psnr_final=psnr,
                    steps=len(moves), first_step=moves[0] if moves else None,
                    mean_move=sum(m["mean"] for m in moves) / n,
                    max_move=max((m["max"] for m in moves), default=0.0),
                    over_voxel=sum(m["over_voxel"] for m in moves) / n)
                print("lr probe:", json.dumps(row), flush=True)
                rows.append(row)
                del tr
                shutil.rmtree(surf_dir, ignore_errors=True)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        del dset_train, dset_test
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--resos", default="256", help="comma list of grid resolutions")
    ap.add_argument("--n_train_images", type=int, default=20)
    ap.add_argument("--image_size", type=int, default=800)
    ap.add_argument("--n_iters_plenoxels", type=int, default=100)
    ap.add_argument("--n_iters_surface", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return probe(a.out_dir, [int(r) for r in a.resos.split(",")], a.n_train_images,
                 a.image_size, a.n_iters_plenoxels, a.n_iters_surface, a.batch_size, a.device)


if __name__ == "__main__":
    main()
