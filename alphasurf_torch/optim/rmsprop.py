"""Masked RMSprop and SGD, the counterpart of the JAX package's
``optim.rmsprop`` (svox2's optim_kernel.cu:28-153).

The port updates in place: the parameter and its rms tensor are written
over, where the JAX package returns new arrays (and its step donates the old
ones, steps.py:443). A row whose gradient is all zero is not touched, as
svox2's sparse indexer does not step unvisited cells. On the card the step
is K7 (``csrc/rmsprop.cu``), which also fuses the surface step's gradient
clip and ``surface_unfrozen`` gate; on the CPU the plain version below.
"""
from __future__ import annotations

import torch

from .. import kernels


def rmsprop_init(param: torch.Tensor) -> torch.Tensor:
    """The rms state of ``param``: zeros of its shape."""
    return torch.zeros_like(param.detach())


def _rmsprop_plain(param, rms, grad, lr, beta, epsilon, minval, grad_abs_max, frozen):
    if grad_abs_max is not None:
        grad = torch.clamp(grad, -grad_abs_max, grad_abs_max)
    mask = torch.any(grad != 0, dim=-1, keepdim=True)
    if frozen:
        mask = torch.zeros_like(mask)
    new_rms = torch.where(mask, beta * rms + (1 - beta) * grad * grad, rms)
    upd = lr * grad / (torch.sqrt(new_rms) + epsilon)
    new_param = torch.where(mask, param - upd, param)
    if minval is not None:
        new_param = torch.clamp(new_param, min=minval)
    rms.copy_(new_rms)
    param.copy_(new_param)


@torch.no_grad()
def rmsprop_step(param: torch.Tensor, rms: torch.Tensor, grad: torch.Tensor, lr: float,
                 beta: float = 0.9, epsilon: float = 1e-8, minval: float | None = None,
                 grad_abs_max: float | None = None, frozen: bool = False) -> None:
    """One RMSprop step of ``param`` (rows, C) and its ``rms``, in place.
    Rows update where any(grad != 0) and not ``frozen``; the gradient is
    first clipped to +-``grad_abs_max`` when given; ``minval`` floors the
    new parameter (rmsprop.py:26-45 with steps.py:374-400)."""
    if param.is_cuda:
        kernels.rmsprop(param, rms, grad.contiguous(), lr, beta, epsilon, minval, grad_abs_max,
                        frozen)
    else:
        _rmsprop_plain(param, rms, grad, lr, beta, epsilon, minval, grad_abs_max, frozen)


@torch.no_grad()
def sgd_step(param: torch.Tensor, grad: torch.Tensor, lr: float) -> None:
    """Masked SGD in place: rows with a nonzero gradient step by -lr * grad."""
    mask = torch.any(grad != 0, dim=-1, keepdim=True)
    param.copy_(torch.where(mask, param - lr * grad, param))
