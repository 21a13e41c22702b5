"""Training CLI, the counterpart of the JAX package's ``app.train``:

    python -m alphasurf_torch.app.train DATA -t CKPT -c cfg.yaml [--key value ...] [--device cuda]

Flags are the JAX package's (svox2's opt.py flag names; reference recipe
configs load unchanged). ``--device`` (default ``cuda``) is the device the
dataset, the grid and the steps live on. Config keys ``dataset_<name>``,
which are not ``Config`` fields, go to the dataset's constructor as
``<name>`` (the synthetic dataset's ``width``, ``height``, ``reso``,
``renderer``...), and ``dataset_test_images`` sets the test split's image
count. Returns the final eval PSNR.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..app.config import load_config
    from ..core.device import resolve_device
    from ..data import datasets
    from ..train.trainer import Trainer

    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(rest)
    print(f"train_dir={cfg.train_dir} data={cfg.data_dir} surface_type={cfg.surface_type} "
          f"backend={cfg.renderer_backend} device={device}")
    ds_kw = {k[len("dataset_"):]: v for k, v in cfg.extra.items() if k.startswith("dataset_")}
    n_test = ds_kw.pop("test_images", None)

    dset = datasets[cfg.dataset_type](
        cfg.data_dir,
        split="train",
        epoch_size=cfg.epoch_size,
        scene_scale=cfg.scene_scale,
        scale=cfg.scale,
        white_bkgd=cfg.white_bkgd,
        n_images=cfg.n_train_images,
        device=device,
        **ds_kw,
    )
    test_kw = {} if n_test is None else {"n_images": n_test}
    try:
        dset_test = datasets[cfg.dataset_type](
            cfg.data_dir, split="test", scene_scale=cfg.scene_scale, scale=cfg.scale,
            white_bkgd=cfg.white_bkgd, device=device, **ds_kw, **test_kw,
        )
    except (FileNotFoundError, AssertionError):
        dset_test = None

    trainer = Trainer(cfg, dset, dset_test, device=device)
    psnr = trainer.train()
    print(f"final eval psnr: {psnr}")
    return psnr


if __name__ == "__main__":
    main(sys.argv[1:])
