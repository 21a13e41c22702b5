"""Scalar losses from the renderer's per-ray accumulators, the counterpart
of the streaming reducers of the JAX package's ``losses.render_losses``
(render_losses.py:104-140). ``ray_losses`` is the renderer's dict of (B,)
tensors. Plain PyTorch: each is a reduction over B values."""
from __future__ import annotations

import torch


def l_dist_from_ray_losses(ray_losses: dict, alphas: bool = True) -> torch.Tensor:
    return torch.mean(ray_losses["l_dist_a" if alphas else "l_dist"])


def l_entropy_from_ray_losses(ray_losses: dict, alphas: bool = False) -> torch.Tensor:
    return torch.mean(ray_losses["l_entropy_a" if alphas else "l_entropy"])


def l_sparsity_from_ray_losses(ray_losses: dict) -> torch.Tensor:
    """sum_j log(sigma_j) (1 - w_j / sum w), weights detached
    (svox2.py:2523-2527)."""
    per_ray_w = torch.clamp(ray_losses["sp_w"], min=1e-10)
    return torch.sum(ray_losses["sp_logsig"] - ray_losses["sp_logsig_w"] / per_ray_w)


def l_inward_norm_from_ray_losses(ray_losses: dict) -> torch.Tensor:
    """Mean over rays of the per-ray sum of alpha * relu(dot(normal, dir))^2
    (normals detached; svox2.py:2559-2590)."""
    return torch.mean(ray_losses["l_inward"])


def density_lap_from_ray_losses(ray_losses: dict) -> torch.Tensor:
    """Mean over all samples of -log(e^-a + e^-(1-a)), shifted positive
    (svox2.py:2608-2617)."""
    n = torch.clamp(torch.sum(ray_losses["lap_cnt"]), min=1.0)
    loss = torch.sum(ray_losses["lap_sum"]) / n
    return loss + torch.log(torch.exp(loss.new_full((), -1.0)) + 1.0)


def udf_var_from_ray_losses(ray_losses: dict) -> torch.Tensor:
    """UDF corner variance over candidate voxels (svox2.py:2597-2606)."""
    n = torch.clamp(torch.sum(ray_losses["udf_var_cnt"]), min=1.0)
    return torch.sum(ray_losses["udf_var_sum"]) / n
