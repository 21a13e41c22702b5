"""Auxiliary per-ray losses, the counterpart of the JAX package's
``losses.render_losses`` (svox2.py:2455-2533; the fused loss gradients of
surf_trav.cu:2143-2400).

Three families, each plain PyTorch:
- sample losses on the (B, S) ``samples`` dict of a renderer called with
  ``return_samples`` (render_losses.py:19-101, 178-186);
- streaming reducers of the renderer's per-ray accumulators
  ``ray_losses``, a dict of (B,) tensors (render_losses.py:104-140);
- the two-pass losses on the first-K sample ``cache``
  (render_losses.py:143-176).
``stop_gradient`` in the JAX package is ``detach()`` here.
"""
from __future__ import annotations

import torch


def _maybe_drop_fake(samples: dict, include_fake: bool):
    if include_fake:
        return samples["alphas"], samples["weights"], samples["ts"], samples["valid"]
    keep = samples["valid"] & ~samples["fake_mask"]
    zero = keep.to(samples["alphas"].dtype)
    return samples["alphas"] * zero, samples["weights"] * zero, samples["ts"] * zero, keep


def l_dist(samples: dict, include_fake: bool = True) -> torch.Tensor:
    """mipnerf-360 distortion on alphas (svox2.py:2466-2472), by the
    streaming identity sum_j a_j (t_j A_j - S_j), A and S the exclusive
    prefix sums of a and a*t (samples in ascending t)."""
    a, _, t, _ = _maybe_drop_fake(samples, include_fake)
    A = torch.cumsum(a, dim=-1) - a
    S = torch.cumsum(a * t, dim=-1) - a * t
    return torch.mean(torch.sum(a * (t * A - S), dim=-1))


def l_entropy(samples: dict, include_fake: bool = True) -> torch.Tensor:
    """InfoNeRF-style entropy on unnormalized weights (svox2.py:2479-2487)."""
    _, w, _, _ = _maybe_drop_fake(samples, include_fake)
    term = torch.where(w > 0.0, -w * torch.log(torch.clamp(w, min=1e-8)), torch.zeros_like(w))
    return torch.mean(torch.sum(term, dim=-1))


def l_dist_alpha(samples: dict, include_fake: bool = True) -> torch.Tensor:
    """Alias: the reference's l_dist already uses alphas (svox2.py:2466)."""
    return l_dist(samples, include_fake)


def _conv_mode(ts, weights, mask) -> torch.Tensor:
    t_mode = torch.gather(ts, -1, torch.argmax(weights, dim=-1, keepdim=True))
    return torch.sum(torch.where(mask, torch.abs(ts - t_mode), torch.zeros_like(ts)))


def l_conv_mode_samp(samples: dict) -> torch.Tensor:
    """Convergence-to-mode (svox2.py:2495-2503): sum |t_i - t_mode| over
    real samples, t_mode the t of the (first) max-weight sample."""
    mask = samples["valid"] & ~samples["fake_mask"] & (samples["alphas"] > 1e-8)
    return _conv_mode(samples["ts"], samples["weights"], mask)


def _samp_dist(a, t, valid) -> torch.Tensor:
    na = (a / torch.clamp(torch.sum(a, dim=-1, keepdim=True), min=1e-8)).detach()
    mean_dist = torch.sum(na * t, dim=-1, keepdim=True)
    per_ray = torch.sum(torch.where(valid, torch.abs(mean_dist - t), torch.zeros_like(t)), dim=-1)
    return torch.mean(per_ray)


def l_samp_dist(samples: dict) -> torch.Tensor:
    """Sample-distance concentration (svox2.py:2509-2515); the normalized
    alphas are detached, as in the reference."""
    a, _, t, valid = _maybe_drop_fake(samples, True)
    return _samp_dist(a, t, valid)


def l_sparsity(samples: dict) -> torch.Tensor:
    """Weight sparsity (svox2.py:2523-2527) over real samples (kernel
    semantics, surf_trav.cu:2286-2300); normalized weights detached."""
    a, w, valid = samples["alphas"], samples["weights"], samples["valid"]
    nw = (w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-10)).detach()
    sigma = -torch.log(torch.clamp(1.0 - a, min=1e-8))
    term = torch.log(torch.clamp(sigma, min=1e-8)) * (1.0 - nw)
    return torch.sum(torch.where(valid, term, torch.zeros_like(term)))


def density_lap_loss(samples: dict) -> torch.Tensor:
    """Bimodal alpha prior (svox2.py:2608-2617): mean over samples of
    -log(exp(-a) + exp(-(1-a))), shifted positive."""
    a, valid = samples["alphas"], samples["valid"]
    p_lap = torch.exp(-a) + torch.exp(-(1.0 - a))
    n = torch.clamp(torch.sum(valid), min=1)
    loss = torch.sum(torch.where(valid, -torch.log(p_lap), torch.zeros_like(a))) / n
    return loss + torch.log(torch.exp(a.new_full((), -1.0)) + 1.0)


# ---------------------------------------------------------------------------
# streaming reducers of ray_losses
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the two-pass losses on the first-K cache
# ---------------------------------------------------------------------------

def _cache_valid(cache: dict) -> torch.Tensor:
    """Written-slot mask of the cache: slot k is valid iff k < n_cached."""
    K = cache["ts"].shape[-1]
    k = torch.arange(K, dtype=cache["n_cached"].dtype, device=cache["n_cached"].device)
    return k[None, :] < cache["n_cached"][:, None]


def l_conv_mode_samp_from_cache(cache: dict) -> torch.Tensor:
    """Convergence-to-mode from the first-K cache (svox2.py:2495-2503)."""
    mask = _cache_valid(cache) & ~cache["fake_mask"] & (cache["alphas"] > 1e-8)
    return _conv_mode(cache["ts"], cache["weights"], mask)


def l_samp_dist_from_cache(cache: dict) -> torch.Tensor:
    """Sample-distance concentration from the first-K cache
    (svox2.py:2509-2515)."""
    return _samp_dist(cache["alphas"], cache["ts"], _cache_valid(cache))
