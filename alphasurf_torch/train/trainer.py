"""The training loop on the host: the counterpart of the JAX package's
``train.trainer.Trainer`` (svox2's opt/opt.py).

The stages are the JAX package's: the Plenoxels warm start on a density
grid (``make_cuvol_step``), then the surface stage (``make_surface_step``),
with schedules evaluated on the host and fed to the steps as Python floats,
periodic eval and checkpoints. The stage transitions are the JAX
package's too (``core.topology``, on the K9 kernels): ``maybe_upsample``
at the end of a step whose count is a multiple of ``upsamp_every``
(a density resample before the surface exists, a surface upsample after),
and ``maybe_init_surface`` at the top of step ``no_surface_init_iters``;
when the two meet, the density grid is resampled first. Each transition
is logged with its capacity, its wall seconds and the voxels the
occupancy (K1d or K1) finds occupied before it and at its first refresh
after it, kept in ``transitions`` and written to ``transitions.json`` in
the train dir.
Multi-device runs raise (ROADMAP §1 item 3). ``surface_renderer`` picks
the steps' renderer (packed, compact or dense; as in JAX, a warm start
that is not packed trains through the dense cuvol march), and
``lambda_conv_mode_samp`` > 0 or ``lambda_l_samp_dist`` > 0 turns on the
two-pass losses on the first-K sample cache, as in the JAX Trainer.

What the JAX Trainer needs and the port does not: its pool budget and the
machinery around it (``_pow2``, ``_size_pool_from_grid``, ``_grow_pool``,
the overflow half of ``_flush_pend``, ``n_forced_steps``). The port's pool
is sized exactly each step and never overflows. Left out: TensorBoard
logging (the log lines carry the same scalars). A final eval adds LPIPS
when ``utils.lpips.make_lpips`` finds its weights. With ``log_pts`` each eval of a surface grid
extracts its iso points (``_eval_points``, on K9g) and, with ``eval_cf``,
adds their Chamfer distance to ``{data_dir}/shape.npy`` to the
``eval stats:`` line.

The batch stream is the JAX Trainer's host mode: each epoch's order is
``np.random.default_rng(cfg.seed)``'s permutation, and each batch is
gathered by index from the ray table on the device. The regularizer windows
come from a CPU ``torch.Generator`` seeded with ``cfg.seed``. A step waits
on the device once, for K2's pool size; the mse is read back only every
``print_every`` steps.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from os import path
from typing import Optional

import numpy as np
import torch

from .. import defs
from ..app.config import Config, render_options_from
from ..core import topology
from ..core.device import resolve_device
from ..core.grid import create_grid
from ..core.rays import Rays
from ..data.base import camera_of
from ..losses.reg import row_coords_of
from ..optim.schedules import expon_lr_func, linear_lr_func, make_decay_func
from ..render.cuvol import density_occupancy_words
from ..render.image import render_image
from ..render.surface import occupancy_words
from ..utils.io import load_grid, save_grid
from ..utils.lpips import make_lpips
from ..utils.metrics import compute_ssim
from .steps import HParams, StepConfig, init_rms, make_cuvol_step, make_surface_step


class Trainer:
    def __init__(self, cfg: Config, dset, dset_test=None, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.dset = dset
        self.dset_test = dset_test
        self.device = resolve_device(device)
        self.dtype = dtype
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.gstep = 0
        n_dev = int(getattr(cfg, "n_devices", 1) or 0)
        if n_dev == 0:  # all visible devices
            n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if n_dev > 1 or int(getattr(cfg, "mesh_model", 1)) > 1:
            raise NotImplementedError(
                f"multi-device training (n_devices={cfg.n_devices}, mesh_model="
                f"{cfg.mesh_model}) is not ported yet (ROADMAP §1 item 3)")
        os.makedirs(cfg.train_dir, exist_ok=True)
        self.log_lines = []
        # the effective config, for reproducibility (opt.py:81-86)
        with open(path.join(cfg.train_dir, "args.yaml"), "w") as f:
            for k, v in sorted(dataclasses.asdict(cfg).items()):
                f.write(f"{k}: {v!r}\n")
        self._build_grid()
        self._build_schedules()
        self.rms = init_rms(self.grid)
        self._step_fns = {}
        self._occ = None  # occupancy words, refreshed every occ_refresh_every steps
        self._occ_step = -1
        self._occ_kind = None  # 'surface' | 'density'
        self._row_coords = None  # per topology
        self.transitions = []  # one dict per stage transition

    # ---------------- grid construction ----------------
    def _build_grid(self):
        cfg = self.cfg
        surface_type = defs.SURFACE_TYPE_STRS.get(cfg.surface_type, defs.SURFACE_TYPE_NONE)
        reso0 = cfg.reso[0] if isinstance(cfg.reso[0], (list, tuple)) else cfg.reso
        self.reso_id = 0
        radius = [r * cfg.scene_radius_rescale for r in self.dset.scene_radius]

        resume = path.join(cfg.train_dir, "ckpt.npz")
        if cfg.load_ckpt and path.isfile(resume):
            # resume an interrupted run (opt.py:116-123): grid and step
            # counter; the rms state starts at zero, as svox2's does
            self.grid, step_id = load_grid(resume, device=self.device, dtype=self.dtype)
            self.gstep = int(step_id)
            self.pretrained_density = False
            self.target_surface_type = (self.grid.surface_type
                                        if self.grid.surface_data is not None else surface_type)
            self.surface_initialized = self.grid.surface_data is not None
            for i, r in enumerate(cfg.reso):
                rr = tuple(r) if isinstance(r, (list, tuple)) else (r,) * 3
                if rr == tuple(self.grid.reso):
                    self.reso_id = i
            self.log(f"[resume] {resume} at step {self.gstep}")
            return

        if cfg.load_pretrain_density_sh:
            # warm start from a Plenoxels checkpoint (opt.py:288-372)
            ckpt = cfg.load_pretrain_density_sh
            if path.isdir(ckpt):
                ckpt = path.join(ckpt, "ckpt.npz")
            self.grid, _ = load_grid(ckpt, device=self.device, dtype=self.dtype)
            if cfg.density_load_rescale != 1.0:
                with torch.no_grad():
                    self.grid.density_data.mul_(cfg.density_load_rescale)
            self.pretrained_density = True
        else:
            self.grid = create_grid(
                reso0,
                radius=radius,
                center=self.dset.scene_center,
                basis_dim=cfg.sh_dim,
                surface_type=surface_type
                if cfg.no_surface_init_iters == 0 and surface_type != defs.SURFACE_TYPE_NONE
                else defs.SURFACE_TYPE_NONE,
                use_sphere_bound=self.dset.use_sphere_bound and not cfg.nosphereinit,
                # the foreground starts at 0 until lr_fg_begin_step (opt.py:148-150)
                init_sigma=0.0 if cfg.lr_fg_begin_step > 0 else cfg.init_sigma,
                dtype=self.dtype,
                device=self.device,
            )
            self.pretrained_density = False
        self.target_surface_type = surface_type
        self.surface_initialized = self.grid.surface_data is not None

    def _build_schedules(self):
        cfg = self.cfg
        self.lr_sigma_func = expon_lr_func(
            cfg.lr_sigma, cfg.lr_sigma_final, cfg.lr_sigma_delay_steps,
            cfg.lr_sigma_delay_mult, cfg.lr_sigma_decay_steps,
        )
        self.lr_alpha_func = expon_lr_func(
            cfg.lr_alpha, cfg.lr_alpha_final, cfg.lr_alpha_delay_steps,
            cfg.lr_alpha_delay_mult, cfg.lr_alpha_decay_steps, cfg.lr_alpha_fix_delay,
        )
        self.lr_surface_func = expon_lr_func(
            cfg.lr_surface, cfg.lr_surface_final, cfg.lr_surface_delay_steps,
            cfg.lr_surface_delay_mult, cfg.lr_surface_decay_steps, cfg.lr_surf_fix_delay,
        )
        self.lr_sh_func = expon_lr_func(
            cfg.lr_sh, cfg.lr_sh_final, cfg.lr_sh_delay_steps,
            cfg.lr_sh_delay_mult, cfg.lr_sh_decay_steps,
        )
        self.lr_sh_surf_func = expon_lr_func(
            cfg.lr_sh_surf, cfg.lr_sh_surf_final, cfg.lr_sh_surf_delay_steps,
            cfg.lr_sh_surf_delay_mult, cfg.lr_sh_surf_decay_steps, cfg.lr_sh_surf_fix_delay,
        )
        self.lr_fss_func = expon_lr_func(
            cfg.lr_fake_sample_std, cfg.lr_fake_sample_std_final,
            cfg.lr_fake_sample_std_delay_steps, cfg.lr_fake_sample_std_delay_mult,
            cfg.lr_fake_sample_std_decay_steps,
        )
        self.fake_sample_std_func = make_decay_func(
            cfg.fs_std_decay_type, cfg.fake_sample_std, cfg.fake_sample_std_final,
            cfg.fake_sample_std_delay, max_steps=cfg.fake_sample_std_decay_steps,
        )
        self.trunc_vol_a_func = make_decay_func(
            cfg.trunc_vol_a_decay_type, cfg.truncated_vol_render_a,
            cfg.truncated_vol_render_a_final, cfg.truncated_vol_render_a_delay,
            max_steps=cfg.truncated_vol_render_a_decay_steps,
        )
        # normal-loss lambda schedule (opt.py:241-247, 713-718)
        if cfg.surf_normal_loss_lambda_type == "linear":
            self.lambda_normal_l1_func = linear_lr_func(
                cfg.lambda_normal_loss_l1, cfg.lambda_normal_loss_l1_final,
                cfg.lambda_normal_loss_l1_delay_steps, cfg.lambda_normal_loss_l1_decay_steps,
            )
            self.lambda_normal_l2_func = linear_lr_func(
                cfg.lambda_normal_loss_l2, cfg.lambda_normal_loss_l2_final,
                cfg.lambda_normal_loss_l2_delay_steps, cfg.lambda_normal_loss_l2_decay_steps,
            )
        else:
            self.lambda_normal_l1_func = lambda _: cfg.lambda_normal_loss_l1
            self.lambda_normal_l2_func = lambda _: cfg.lambda_normal_loss_l2

    # ---------------- per-stage steps ----------------
    def _get_step(self, kind: str, no_surface: bool):
        cfg = self.cfg
        cache_key = (kind, self.grid.reso, self.grid.capacity,
                     None if self.grid.level_set_data is None
                     else self.grid.level_set_data.shape[0])
        if cache_key in self._step_fns:
            return self._step_fns[cache_key]
        scfg = StepConfig(
            opt=render_options_from(cfg, no_surface=no_surface),
            tv_sparsity=cfg.tv_sparsity,
            tv_sh_sparsity=cfg.tv_sh_sparsity,
            tv_surface_sparsity=cfg.tv_surface_sparsity,
            norm_surface_sparsity=cfg.norm_surface_sparsity,
            sparsify_sparsity=cfg.alpha_surf_sparsify_sparsity,
            norm_con_check=not cfg.no_surf_norm_con_check,
            norm_ignore_empty=cfg.surf_norm_reg_ignore_empty,
            sparsify_surf_decrease=cfg.sparsify_surf_decrease,
            sparsify_surf_thresh=cfg.sparsify_surf_thresh,
            surf_tv_alpha_weighted=cfg.surf_tv_alpha_dependency,
            rms_beta=cfg.rms_beta,
            surf_grad_abs_max=cfg.surf_grad_abs_max,
            use_two_pass_losses=(cfg.lambda_conv_mode_samp > 0 or cfg.lambda_l_samp_dist > 0),
            use_eikonal=cfg.lambda_surface_eikonal > 0,
            renderer=cfg.surface_renderer,
        )
        fn = make_cuvol_step(scfg) if kind == "cuvol" else make_surface_step(scfg)
        self._step_fns[cache_key] = fn
        return fn

    def _hparams(self, no_surface: bool) -> HParams:
        cfg = self.cfg
        g = self.gstep
        lr_sh = (self.lr_sh_func(g) if (not self.surface_initialized or no_surface)
                 else self.lr_sh_surf_func(g))
        frozen = self.surface_initialized and (
            g < cfg.surface_init_freeze + cfg.no_surface_init_iters)
        # density optimization gated until lr_fg_begin_step (opt.py:1118)
        fg_on = g >= cfg.lr_fg_begin_step
        return HParams(
            lr_sigma=self.lr_sigma_func(g) if fg_on else 0.0,
            lr_alpha=self.lr_alpha_func(g) if fg_on else 0.0,
            lr_surface=self.lr_surface_func(g),
            lr_sh=lr_sh,
            lr_fake_sample_std=self.lr_fss_func(g),
            img_lambda_l1_ratio=cfg.img_lambda_l1_ratio,
            lambda_tv=cfg.lambda_tv,
            lambda_tv_sh=cfg.lambda_tv_sh,
            lambda_tv_alpha=cfg.lambda_tv_alpha,
            lambda_tv_surface=cfg.lambda_tv_surface,
            lambda_normal_l1=self.lambda_normal_l1_func(g),
            lambda_normal_l2=self.lambda_normal_l2_func(g),
            lambda_sparsify_alpha=(cfg.lambda_sparsify_alpha if g > cfg.delay_sparsify_alpha
                                   else 0.0),
            lambda_sparsify_surf=cfg.lambda_sparsify_surf if g > cfg.delay_sparsify_surf else 0.0,
            lambda_l_dist=cfg.lambda_l_dist,
            lambda_l_dist_a=cfg.lambda_l_dist_a,
            lambda_l_entropy=cfg.lambda_l_entropy if g < cfg.l_entropy_step else 0.0,
            lambda_l_entropy_a=cfg.lambda_l_entropy_a if g < cfg.l_entropy_step else 0.0,
            lambda_conv_mode_samp=cfg.lambda_conv_mode_samp if g < cfg.conv_mode_step else 0.0,
            lambda_samp_dist=cfg.lambda_l_samp_dist,
            lambda_sparsity=cfg.lambda_sparsity
            if (not self.surface_initialized or no_surface) else cfg.lambda_inplace_alpha_sparsify,
            lambda_eikonal=cfg.lambda_surface_eikonal,
            lambda_inward_norm=cfg.lambda_inwards_norm_loss,
            lambda_density_lap=cfg.lambda_no_surf_init_density_lap_loss
            if not self.surface_initialized else 0.0,
            lambda_udf_var=cfg.lambda_udf_var_loss,
            lambda_fs_std_l1=cfg.lambda_fake_sample_std_l1,
            lambda_fs_std_l2=cfg.lambda_fake_sample_std_l2,
            surface_unfrozen=0.0 if frozen else 1.0,
        )

    # ---------------- stage transitions ----------------
    def _resample_cameras(self):
        """Every training camera at full resolution, for the weight and
        visibility sweeps (opt.py:193-202), each with its own intrinsics
        where the dataset has per-image ones (DTU; the JAX Trainer hands the
        whole array to every camera)."""
        return [camera_of(self.dset, i) for i in range(self.dset.n_images)]

    @staticmethod
    def _n_occupied(words) -> Optional[int]:
        """Occupied voxels in K1/K1d words (their padding bits are 0)."""
        if words is None:
            return None
        bits = (words[..., None] >> torch.arange(32, dtype=torch.int32, device=words.device)) & 1
        return int(bits.sum())

    def _write_transitions(self):
        with open(path.join(self.cfg.train_dir, "transitions.json"), "w") as f:
            json.dump(self.transitions, f, indent=1)

    def _new_topology(self, kind: str, t0: float, occupied_before: Optional[int]):
        """After a transition: fresh rms state, occupancy and row coords;
        the transition logged with its capacity and wall seconds (its
        occupancy after is filled in at the next refresh, ``_get_occ``)."""
        self.rms = init_rms(self.grid)
        self._occ = None
        self._row_coords = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec = dict(kind=kind, step=self.gstep, reso=list(self.grid.reso),
                   capacity=self.grid.capacity, seconds=time.perf_counter() - t0,
                   occupied_before=occupied_before, occupied_after=None)
        self.transitions.append(rec)
        self._write_transitions()
        self.log(f"[stage] {kind} at step {self.gstep}: reso {rec['reso']}, capacity "
                 f"{rec['capacity']}, {rec['seconds']:.3f} s")

    def maybe_init_surface(self):
        """Density -> SDF conversion at no_surface_init_iters
        (opt.py:747-780), or at once when warm-starting from a Plenoxels
        checkpoint."""
        cfg = self.cfg
        if self.surface_initialized or self.target_surface_type == defs.SURFACE_TYPE_NONE:
            return
        self.log(f"[stage] init_surface_from_density at step {self.gstep}")
        t0 = time.perf_counter()
        occ_before = self._n_occupied(self._occ)
        need_cams = cfg.surf_init_type == "weight" or cfg.visibility_pruning_scale > 0
        rays = getattr(self.dset, "rays_init", None)
        self.grid = topology.init_surface_from_density(
            self.grid,
            density_lvs=cfg.surf_init_density_lvs,
            alpha_rescale=cfg.surf_init_alpha_rescale,
            prune_threshold=min(cfg.surf_init_density_lvs) / 2,
            dilate=cfg.surf_init_dilate,
            zero_lv_density=cfg.zero_lv_density,
            init_type=cfg.surf_init_type,
            weight_init_cams=self._resample_cameras() if need_cams else None,
            visibility_pruning_scale=cfg.visibility_pruning_scale,
            # DTU-style mask pruning (opt.py:345-352)
            mask_pruning_rays=rays if getattr(rays, "mask", None) is not None else None,
        )
        self.grid = self.grid.replace(surface_type=self.target_surface_type)
        self.surface_initialized = True
        self._new_topology("init_surface_from_density", t0, occ_before)

    def maybe_upsample(self):
        """At the end of every upsamp_every-th step, resample onto the next
        reso (opt.py:1228-1272): TV early-off or decay first, the weight
        threshold over the training cameras (thresh_type 'weight')."""
        cfg = self.cfg
        if self.reso_id + 1 >= len(cfg.reso):
            return
        if not (self.gstep > 0 and self.gstep % cfg.upsamp_every == 0):
            return
        self.reso_id += 1
        new_reso = cfg.reso[self.reso_id]
        self.log(f"[stage] upsample -> {new_reso} at step {self.gstep}")
        t0 = time.perf_counter()
        occ_before = self._n_occupied(self._occ)
        # TV early-off or decay at the first upsample (opt.py:1235-1243)
        if cfg.tv_early_only > 0:
            cfg.lambda_tv = 0.0
            cfg.lambda_tv_alpha = 0.0
            cfg.lambda_tv_sh = 0.0
        elif cfg.tv_decay != 1.0:
            cfg.lambda_tv *= cfg.tv_decay
            cfg.lambda_tv_alpha *= cfg.tv_decay
            cfg.lambda_tv_sh *= cfg.tv_decay
        z_reso = new_reso if isinstance(new_reso, int) else new_reso[2]
        cams = self._resample_cameras() if cfg.thresh_type == "weight" else None
        if self.grid.surface_data is not None:
            self.grid = topology.resample_surface(
                self.grid, new_reso, alpha_thresh=cfg.alpha_upsample_thresh,
                weight_thresh=cfg.weight_thresh / z_reso, dilate=2, cameras=cams,
                max_elements=cfg.max_grid_elements, non_expanding=cfg.surf_non_expand,
                sigmoid_alpha=cfg.surf_alpha_sigmoid_act, keep_lv_band=cfg.upsample_keep_lv_band)
        else:
            self.grid = topology.resample(
                self.grid, new_reso, sigma_thresh=cfg.density_thresh,
                weight_thresh=cfg.weight_thresh / z_reso, dilate=2, cameras=cams,
                max_elements=cfg.max_grid_elements)
        if cfg.upsample_density_add:
            self.grid = self.grid.replace(
                density_data=self.grid.density_data + cfg.upsample_density_add)
        self._new_topology("upsample", t0, occ_before)

    def _get_occ(self, no_surface: bool):
        """The occupancy words, recomputed every occ_refresh_every steps or
        on a change of kind or shape: K1d for density grids (and no_surface
        renders), K1 for surface grids."""
        cfg = self.cfg
        kind = "density" if (no_surface or self.grid.surface_data is None) else "surface"
        X, Y, Z = self.grid.reso
        if (
            self._occ is None
            or kind != self._occ_kind
            or self.gstep - self._occ_step >= max(1, cfg.occ_refresh_every)
            or tuple(self._occ.shape) != (X - 1, Y - 1, (Z - 1 + 31) // 32)
        ):
            if kind == "density":
                self._occ = density_occupancy_words(self.grid)
            else:
                self._occ = occupancy_words(self.grid, render_options_from(cfg, no_surface))
            self._occ_step = self.gstep
            self._occ_kind = kind
            if self.transitions and self.transitions[-1]["occupied_after"] is None:
                rec = self.transitions[-1]
                rec["occupied_after"] = self._n_occupied(self._occ)
                self._write_transitions()
                self.log(f"[stage] occupied voxels around the {rec['kind']} at step "
                         f"{rec['step']}: {rec['occupied_before']} -> {rec['occupied_after']}")
        return self._occ

    def _get_row_coords(self):
        if self._row_coords is None or self._row_coords.shape[0] != self.grid.capacity:
            self._row_coords = row_coords_of(self.grid)
        return self._row_coords

    # ---------------- core loop ----------------
    def log(self, msg):
        print(msg, flush=True)
        self.log_lines.append(msg)

    def _set_grid_scalars(self):
        """Scheduled grid scalars (opt.py:720-735): fake_sample_std,
        truncated_vol_render_a, and the level sets whose truncated-vol
        reweight has decayed to nothing."""
        cfg = self.cfg
        g = self.grid
        fss = self.fake_sample_std_func(self.gstep)
        with torch.no_grad():
            if g.fake_sample_std is not None and not cfg.trainable_fake_sample_std:
                g.fake_sample_std.fill_(fss)
            elif g.fake_sample_std is None and cfg.surf_fake_sample and g.surface_data is not None:
                g.fake_sample_std = torch.nn.Parameter(
                    torch.full((1, 1), fss, dtype=g.dtype, device=self.device), requires_grad=False)
            a_now = self.trunc_vol_a_func(self.gstep)
            g.truncated_vol_render_a.fill_(a_now)
            if (cfg.trunc_vol_render_lv_remove and cfg.truncated_vol_render
                    and g.surface_data is not None and g.level_set_data.shape[0] > 1):
                ids = np.arange(g.level_set_data.shape[0])
                x = np.clip(a_now - ids, 0.0, 1.0)
                keep = 0.5 * (1.0 - np.cos(np.pi * x)) > 1e-20
                if keep.sum() < len(ids):
                    n_rm = int(len(ids) - keep.sum())
                    g.level_set_data = g.level_set_data[torch.as_tensor(keep, device=self.device)]
                    g.density_data.add_(cfg.trunc_vol_lv_rm_density_add * n_rm)
                    self.log(f"[stage] trunc_vol_render_lv_remove: {n_rm} level set(s) dropped "
                             f"at step {self.gstep} (a={a_now:.3f})")

    def train(self, n_iters: Optional[int] = None):
        cfg = self.cfg
        n_iters = n_iters or cfg.n_iters
        dset = self.dset
        if self.pretrained_density and not self.surface_initialized:
            self.maybe_init_surface()
        if dset.rays_dev is None or dset.rays_dev["origins"].device != self.device:
            dset.to_device(self.device)
        table = dset.rays_dev
        epoch_rays = int(table["origins"].shape[0])
        B = cfg.batch_size
        perm = None
        pend = []  # mse tensors of the steps since the last print
        batch_begin = epoch_rays  # shuffle on the first step
        stats_acc = {"mse": 0.0, "n": 0}
        t_start = time.time()

        def flush_pend():
            nonlocal pend
            for mse in pend:
                stats_acc["mse"] += float(mse)
                stats_acc["n"] += 1
            pend = []

        while self.gstep < n_iters:
            if batch_begin + B > epoch_rays:
                perm = torch.as_tensor(dset.shuffle_perm(self.rng), device=self.device)
                batch_begin = 0
            no_surface = (not self.surface_initialized) or (self.gstep < cfg.no_surface_init_iters)
            if cfg.lr_fg_begin_step > 0 and self.gstep == cfg.lr_fg_begin_step:
                # the foreground begins training now (opt.py:691-692)
                with torch.no_grad():
                    self.grid.density_data.fill_(cfg.init_sigma)
            if self.gstep == cfg.no_surface_init_iters and cfg.no_surface_init_iters > 0:
                self.maybe_init_surface()
                no_surface = not self.surface_initialized

            idx = perm[batch_begin:batch_begin + B]
            batch_begin += B
            if idx.shape[0] < B:  # an epoch_size shorter than the table
                continue
            self._set_grid_scalars()
            kind = "cuvol" if (no_surface or self.grid.surface_data is None) else "surface"
            step_fn = self._get_step(kind, no_surface)
            hp = self._hparams(no_surface)
            rays = Rays(table["origins"][idx], table["dirs"][idx],
                        table["mask"][idx] if "mask" in table else None)
            self.grid, self.rms, stats = step_fn(
                self.grid, self.rms, rays, table["gt"][idx], hp, self.generator,
                occ=self._get_occ(no_surface), row_coords=self._get_row_coords())
            pend.append(stats["mse"])
            self.gstep += 1

            if self.gstep % cfg.print_every == 0:
                flush_pend()
                avg_mse = stats_acc["mse"] / max(stats_acc["n"], 1)
                psnr = -10.0 * math.log10(max(avg_mse, 1e-12))
                dt = time.time() - t_start
                self.log(f"step {self.gstep} [{kind}] mse={avg_mse:.5f} psnr={psnr:.2f} "
                         f"({self.gstep / dt:.1f} it/s)")
                stats_acc = {"mse": 0.0, "n": 0}
            if cfg.eval_every_iter and self.gstep % cfg.eval_every_iter == 0:
                self.eval_step()
            if cfg.save_every > 0 and self.gstep % cfg.save_every == 0:
                self.save()
            self.maybe_upsample()

        flush_pend()
        self.save()
        return self.eval_step(final=True)

    # ---------------- eval / io ----------------
    def eval_step(self, final: bool = False):
        """Test-view evaluation: PSNR and SSIM, and in a final eval LPIPS
        when its weights exist (opt.py:443-538). A final eval writes the
        per-view breakdown to eval_views.txt and the mean PSNR to
        test_psnr.txt."""
        cfg = self.cfg
        dset = self.dset_test or self.dset
        n_views = (dset.n_images if final and cfg.final_render_eval
                   else min(cfg.n_eval_test, dset.n_images))
        if n_views == 0:
            return None
        opt = render_options_from(cfg, no_surface=self.grid.surface_data is None)
        lpips_fn = make_lpips(device=self.device) if final else None
        psnrs, ssims, lpipss, lines = [], [], [], []
        for i in np.linspace(0, dset.n_images - 1, n_views).astype(int):
            cam = camera_of(dset, int(i))
            img = render_image(self.grid, cam, opt, device=self.device)
            gt = np.asarray(dset.gt[i])
            mse = float(np.mean((img - gt) ** 2))
            p = -10.0 * math.log10(max(mse, 1e-12))
            psnrs.append(p)
            s = compute_ssim(img, gt)
            ssims.append(s)
            if lpips_fn is not None:
                lpipss.append(lpips_fn(img, gt))
            lines.append(f"{int(i)} {p:.4f} {s:.4f}")
        mean_psnr = float(np.mean(psnrs))
        mean_ssim = float(np.mean(ssims))
        extra = f" lpips={np.mean(lpipss):.4f}" if lpipss else ""
        self.log(f"eval stats: step={self.gstep} psnr={mean_psnr:.3f} ssim={mean_ssim:.4f}"
                 f"{extra}{self._eval_points()}")
        if final:
            with open(path.join(cfg.train_dir, "eval_views.txt"), "w") as f:
                f.write("view psnr ssim\n" + "\n".join(lines) + "\n")
            with open(path.join(cfg.train_dir, "test_psnr.txt"), "w") as f:
                f.write(f"{mean_psnr}\n")
        return mean_psnr

    def _eval_points(self) -> str:
        """In-training point extraction and Chamfer (opt.py:596-657), with
        ``log_pts``, for surface grids: the iso points of each level set
        (world units over a scene scale of 2/3); with ``eval_cf`` and a
        ``{data_dir}/shape.npy``, downsampled to 0.001 and held against it.
        Writes ``coarse_pts_eval/{step}/`` (cf.txt and vis_d2s.ply, or
        pts.ply) under the train dir and returns the `` cf_*`` tail of the
        ``eval stats:`` line."""
        cfg = self.cfg
        if not cfg.log_pts or self.grid.surface_data is None:
            return ""
        from ..geometry.chamfer import chamfer, downsample_points
        from ..geometry.dtu_eval import write_ply_points
        from ..geometry.extract import extract_iso_points

        pred = [extract_iso_points(self.grid, n_sample=cfg.surf_eval_n_sample,
                                   density_thresh=cfg.surf_eval_intersect_th,
                                   surf_lv_set=float(lv), to_world=True, scene_scale=2.0 / 3.0)
                for lv in self.grid.level_set_data.detach().cpu().numpy()]
        pred = [p for p in pred if p.size]
        pred = np.concatenate(pred, axis=0) if pred else np.zeros((0, 3), np.float32)
        out_dir = path.join(cfg.train_dir, "coarse_pts_eval", str(self.gstep))
        os.makedirs(out_dir, exist_ok=True)
        gt_path = path.join(cfg.data_dir, "shape.npy")
        if cfg.eval_cf and pred.size and path.isfile(gt_path):
            pred = downsample_points(pred, 0.001)  # opt.py:606-615
            cf = chamfer(pred, np.load(gt_path).astype(np.float32).reshape(-1, 3))
            with open(path.join(out_dir, "cf.txt"), "w") as f:
                f.write(f"Mean d2s: {cf['d2s']}\n")
                f.write(f"Mean s2d: {cf['s2d']}\n")
                f.write(f"Over all: {cf['overall']}\n")
            write_ply_points(path.join(out_dir, "vis_d2s.ply"), pred)
            return (f" cf_d2s={cf['d2s']:.5f} cf_s2d={cf['s2d']:.5f}"
                    f" cf_mean={cf['overall']:.5f}")
        if pred.size:
            write_ply_points(path.join(out_dir, "pts.ply"), pred)
        return ""

    def save(self):
        ckpt_path = path.join(self.cfg.train_dir, "ckpt.npz")
        save_grid(self.grid, ckpt_path, step_id=self.gstep)
        self.log(f"saved {ckpt_path}")
