"""Config and flags: a copy of the JAX package's ``app.config``.

Flag-name compatible with svox2's opt/util/config_util.py: reference
recipe configs (``key = value`` lines, each value yaml) parse unchanged,
with the layering defaults < config file < ``--key value`` flags done
directly. Keys that are not ``Config`` fields land in ``Config.extra``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import yaml


@dataclasses.dataclass
class Config:
    # --- data ---
    data_dir: str = ""
    dataset_type: str = "auto"
    scene_scale: Optional[float] = None
    scale: Optional[float] = None
    epoch_size: Optional[int] = None
    white_bkgd: bool = True
    llffhold: int = 8
    scene_radius_rescale: float = 1.0
    dtu_no_mask: bool = False
    n_train_images: Optional[int] = None

    # --- render options ---
    step_size: float = 0.5
    sigma_thresh: float = 1e-8
    stop_thresh: float = 1e-7
    background_brightness: float = 1.0
    renderer_backend: str = "surf_trav"
    surf_alpha_sigmoid_act: bool = False
    surface_type: str = "none"
    near_clip: float = 0.0
    use_spheric_clip: bool = False
    last_sample_opaque: bool = False

    surf_fake_sample: bool = False
    limited_fake_sample: bool = False
    surf_fake_sample_min_vox_len: float = 0.1
    no_surf_grad_from_sh: bool = False
    no_fake_sample_l_dist: bool = False
    no_fake_sample_normalize_surf: bool = False
    only_outward_intersect: bool = False
    truncated_vol_render: bool = False
    trunc_vol_render_lv_remove: bool = False
    trunc_vol_weight_min: float = 0.0
    trunc_vol_lv_rm_density_add: float = 0.0

    # --- general training ---
    train_dir: str = "ckpt"
    reso: List[List[int]] = dataclasses.field(
        default_factory=lambda: [[256, 256, 256], [512, 512, 512]]
    )
    upsamp_every: int = 3 * 12800
    init_iters: int = 0
    no_surface_init_iters: int = 0
    surface_init_freeze: int = 0
    surf_init_density_lvs: List[float] = dataclasses.field(default_factory=lambda: [0.5])
    surf_init_alpha_rescale: Optional[float] = None
    surf_init_dilate: int = 2
    surf_init_type: str = "density"
    visibility_pruning_scale: float = 0.01
    zero_lv_density: Optional[float] = None
    surface_init_reset_alpha: bool = False
    surf_init_reset_all: bool = False
    surface_init_rescale: float = 0.1
    basis_type: str = "sh"
    sh_dim: int = 9
    n_iters: int = 10 * 12800
    batch_size: int = 5000
    init_sigma: float = 0.1
    nosphereinit: bool = False
    load_pretrain_density_sh: str = ""
    load_ckpt: bool = False
    density_load_rescale: float = 1.0
    lr_fg_begin_step: int = 0

    # --- optimization (lr schedules) ---
    lr_sigma: float = 3e1
    lr_sigma_final: float = 5e-2
    lr_sigma_decay_steps: int = 250000
    lr_sigma_delay_steps: int = 15000
    lr_sigma_delay_mult: float = 1e-2
    lr_alpha: float = 3e1
    lr_alpha_final: float = 5e-2
    lr_alpha_decay_steps: int = 250000
    lr_alpha_delay_steps: int = 15000
    lr_alpha_delay_mult: float = 1e-2
    lr_alpha_fix_delay: int = 0
    lr_surface: float = 3e1
    lr_surface_final: float = 5e-2
    lr_surface_decay_steps: int = 250000
    lr_surface_delay_steps: int = 15000
    lr_surface_delay_mult: float = 1e-2
    lr_surf_fix_delay: int = 0
    lr_sh: float = 1e-2
    lr_sh_final: float = 5e-6
    lr_sh_decay_steps: int = 250000
    lr_sh_delay_steps: int = 0
    lr_sh_delay_mult: float = 1e-2
    lr_sh_surf: float = 1e-2
    lr_sh_surf_final: float = 5e-6
    lr_sh_surf_decay_steps: int = 250000
    lr_sh_surf_delay_steps: int = 0
    lr_sh_surf_delay_mult: float = 1e-2
    lr_sh_surf_fix_delay: int = 0
    lr_decay: bool = True
    rms_beta: float = 0.95
    trainable_fake_sample_std: bool = False
    lr_fake_sample_std: float = 1e-1
    lr_fake_sample_std_final: float = 5e-2
    lr_fake_sample_std_decay_steps: int = 250000
    lr_fake_sample_std_delay_steps: int = 15000
    lr_fake_sample_std_delay_mult: float = 1e-2
    lambda_fake_sample_std_l1: float = 1e-2
    lambda_fake_sample_std_l2: float = 1e-2

    fs_std_decay_type: str = "exp"
    fake_sample_std: float = 1.0
    fake_sample_std_final: float = 0.05
    fake_sample_std_decay_steps: int = 50000
    fake_sample_std_delay: int = 0
    trunc_vol_a_decay_type: str = "exp"
    truncated_vol_render_a: float = 1.0
    truncated_vol_render_a_final: float = 0.05
    truncated_vol_render_a_decay_steps: int = 50000
    truncated_vol_render_a_delay: int = 0

    # --- losses ---
    img_lambda_l1_ratio: float = 0.0
    lambda_tv: float = 1e-5
    lambda_tv_alpha: float = 1e-5
    lambda_tv_surface: float = 0.0
    lambda_tv_sh: float = 1e-3
    tv_sparsity: float = 0.01
    tv_sh_sparsity: float = 0.01
    tv_surface_sparsity: float = 0.01
    norm_surface_sparsity: float = 0.01
    surf_tv_alpha_dependency: bool = False
    lambda_normal_loss: float = 0.0  # alias used by recipe configs
    lambda_normal_loss_l1: float = 0.0
    lambda_normal_loss_l2: float = 0.0
    surf_normal_loss_lambda_type: str = "const"
    lambda_normal_loss_l1_final: float = 0.0
    lambda_normal_loss_l1_delay_steps: float = 0.0
    lambda_normal_loss_l1_decay_steps: float = 0.0
    lambda_normal_loss_l2_final: float = 0.0
    lambda_normal_loss_l2_delay_steps: float = 0.0
    lambda_normal_loss_l2_decay_steps: float = 0.0
    no_surf_norm_con_check: bool = False
    surf_norm_reg_ignore_empty: bool = False
    surf_norm_reg_l1: bool = False
    lambda_surface_eikonal: float = 0.0
    lambda_inwards_norm_loss: float = 0.0
    lambda_no_surf_init_density_lap_loss: float = 0.0
    lambda_udf_var_loss: float = 0.0
    lambda_l_dist: float = 0.0
    lambda_l_entropy: float = 0.0
    lambda_l_dist_a: float = 0.0
    lambda_l_entropy_a: float = 0.0
    lambda_l_samp_dist: float = 0.0
    lambda_conv_mode_samp: float = 0.0
    conv_mode_step: int = 100000
    l_entropy_step: int = 100000
    lambda_sparsity: float = 0.0
    lambda_inplace_alpha_sparsify: float = 0.0
    lambda_sparsify_alpha: float = 0.0
    lambda_sparsify_surf: float = 0.0
    delay_sparsify_alpha: int = 0
    delay_sparsify_surf: int = 0
    sparsify_surf_decrease: bool = False
    sparsify_surf_thresh: float = 0.1
    alpha_surf_sparsify_sparsity: float = 0.01
    surf_grad_abs_max: Optional[float] = None

    # recompute the voxel-occupancy skip structure every N surface steps
    # (the JAX package's knob: the analog of svox2 recomputing its accel
    # structure only on topology changes, svox2.py:4483-4490; 1 = every step)
    occ_refresh_every: int = 16
    # production renderer: 'packed' (global entry pool), 'compact'
    # (per-ray K slots), or 'dense' (full DDA walk; oracle path)
    surface_renderer: str = "packed"
    entries_per_ray: float = 8.0
    # hard bound on the packed pool budget (memory = batch_size *
    # entries_per_ray entries); overflow past this cap logs an ERROR and
    # applies degraded updates rather than stalling
    entries_per_ray_max: float = 256.0
    supers_per_ray: float = 8.0

    # --- multi-device (the JAX package's; no svox2 analog; not ported, ROADMAP §1 item 3) ---
    # number of mesh devices for data-parallel ray sharding: 1 = single
    # device, 0 = all visible devices. Grid params are replicated (or
    # tile-sharded over mesh_model rows); gradient psum over ICI is
    # inserted by XLA from the sharding annotations.
    n_devices: int = 1
    # model-axis size for tile-sharding packed grid rows (>HBM grids)
    mesh_model: int = 1

    # --- thresholds / upsampling ---
    thresh_type: str = "weight"
    weight_thresh: float = 0.0005 * 512
    density_thresh: float = 5.0
    alpha_upsample_thresh: float = 1e-8
    max_grid_elements: int = 44_000_000
    upsample_density_add: float = 0.0
    surf_non_expand: bool = False
    # keep the level-set crossing band in surface upsamples (the JAX package's
    # addition, not a reference flag: the reference's alpha-threshold mask
    # assumes the alpha support and surface contours are aligned — true
    # only late in its 50k-iter schedule; without this, short schedules
    # lose the crossing shell at the 512^3 transition)
    upsample_keep_lv_band: bool = True
    tv_early_only: int = 1
    tv_decay: float = 1.0

    # --- logging / eval ---
    print_every: int = 20
    save_every: int = 10000
    eval_every_iter: int = 10000
    n_eval_test: int = 3
    n_eval_train: int = 0
    log_depth_map: bool = False
    log_depth_map_use_thresh: Optional[float] = None
    log_normal_map: bool = False
    log_mse_image: bool = False
    tune_mode: bool = False
    final_render_eval: bool = False
    eval_cf: bool = False
    log_pts: bool = False
    surf_eval_n_sample: int = 3
    surf_eval_intersect_th: float = 0.1
    seed: int = 20200823

    # unknown keys from config files are stored here (forward compat)
    extra: dict = dataclasses.field(default_factory=dict)

    # -- convenience --
    @property
    def no_white_bkgd(self):
        return not self.white_bkgd


_FIELDS = {f.name for f in dataclasses.fields(Config)}
# flags spelled as their negation in the reference configs
_NEGATED = {
    "no_white_bkgd": "white_bkgd",
    "nokernel": None,
    "no_lr_decay": "lr_decay",
}


def parse_config_file(path: str) -> dict:
    """Parse a reference-style ``key = value`` config file (each value is
    yaml), ignoring comments and blank lines."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            try:
                out[key] = yaml.safe_load(val.strip())
            except yaml.YAMLError:
                out[key] = val.strip()
    return out


def apply_dict(cfg: Config, d: dict) -> Config:
    for k, v in d.items():
        if k in _NEGATED:
            tgt = _NEGATED[k]
            if tgt is not None:
                setattr(cfg, tgt, not bool(v))
            continue
        if k in _FIELDS:
            setattr(cfg, k, v)
        else:
            cfg.extra[k] = v
    return cfg


def load_config(argv=None) -> Config:
    """CLI entry: ``train.py data_dir -t train_dir -c config [--key value]``."""
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("data_dir", nargs="?", default="")
    ap.add_argument("--config", "-c", default=None)
    ap.add_argument("--train_dir", "-t", default="ckpt")
    args, unknown = ap.parse_known_args(argv)

    cfg = Config()
    if args.config:
        cfg = apply_dict(cfg, parse_config_file(args.config))
    cfg.data_dir = args.data_dir or cfg.data_dir
    cfg.train_dir = args.train_dir

    # --key value overrides
    i = 0
    over = {}
    while i < len(unknown):
        tok = unknown[i]
        if tok.startswith("--"):
            key = tok[2:]
            if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
                over[key] = yaml.safe_load(unknown[i + 1])
                i += 2
            else:
                over[key] = True
                i += 1
        else:
            i += 1
    cfg = apply_dict(cfg, over)
    # alias: recipes set lambda_normal_loss for the l1 variant when
    # surf_norm_reg_l1 is on (opt.py maps lambda_normal_loss -> l1/l2)
    if cfg.lambda_normal_loss:
        if cfg.surf_norm_reg_l1:
            cfg.lambda_normal_loss_l1 = cfg.lambda_normal_loss
        else:
            cfg.lambda_normal_loss_l2 = cfg.lambda_normal_loss
    return cfg


def render_options_from(cfg: Config, no_surface: bool = False):
    """args -> RenderOptions (config_util.setup_render_opts equivalent)."""
    from .. import defs
    from ..core.options import RenderOptions

    return RenderOptions(
        backend=cfg.renderer_backend,
        background_brightness=cfg.background_brightness,
        step_size=cfg.step_size,
        sigma_thresh=cfg.sigma_thresh,
        stop_thresh=cfg.stop_thresh,
        near_clip=cfg.near_clip,
        use_spheric_clip=cfg.use_spheric_clip,
        last_sample_opaque=cfg.last_sample_opaque,
        surf_fake_sample=cfg.surf_fake_sample and not no_surface,
        surf_fake_sample_min_vox_len=cfg.surf_fake_sample_min_vox_len,
        limited_fake_sample=cfg.limited_fake_sample,
        no_surf_grad_from_sh=cfg.no_surf_grad_from_sh,
        alpha_activation_type=defs.SIGMOID_FN
        if cfg.surf_alpha_sigmoid_act
        else defs.EXP_FN,
        fake_sample_l_dist=not cfg.no_fake_sample_l_dist,
        fake_sample_normalize_surf=not cfg.no_fake_sample_normalize_surf,
        only_outward_intersect=cfg.only_outward_intersect,
        truncated_vol_render=cfg.truncated_vol_render and not no_surface,
        trunc_vol_weight_min=cfg.trunc_vol_weight_min,
    )
