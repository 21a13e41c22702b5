"""Ray/trilinear-isosurface intersection: cubic coefficients and roots, the
counterpart of the JAX package's ``ops.cubic`` (svox2 render_util.cuh:789-848,
1126-1203; svox2.py:1987-2164).

Roots carry gradients to the coefficients by implicit differentiation, as
the JAX package's custom JVP does (cubic.py:230-242): at a root t of f,
dt/df_i = -t^i / f'(t), with |f'| kept away from 0 and no gradient in slots
without a root. The backward kernel (``csrc/backward.cu``) applies the same
rule.

Powers are written as products so that the plain version rounds exactly
where the CUDA kernel (``csrc/phase_b.cu``) does.
"""
from __future__ import annotations

import math

import torch

NO_ROOT = -1.0  # marker for "no root in this slot" (svox2.py:2051)
_ATOL = 1e-10
_EPS = 1e-10
_ROOT_MAX = 1e4  # roots are voxel-relative; anything larger is degenerate


def cubic_coeffs_T(s8T: torch.Tensor, uT: torch.Tensor, dT: torch.Tensor):
    """Coefficients of f(t) = trilinear(s8)(u + t d), corner and component
    axes leading: s8T (8, ...), uT/dT (3, ...) -> (f0, f1, f2, f3) with
    f(t) = f3 t^3 + f2 t^2 + f1 t + f0."""
    s000, s001, s010, s011, s100, s101, s110, s111 = (s8T[i] for i in range(8))
    ux, uy, uz = uT[0], uT[1], uT[2]
    vx, vy, vz = dT[0], dT[1], dT[2]

    a00 = s000 * (1 - uz) + s001 * uz
    a01 = s010 * (1 - uz) + s011 * uz
    a10 = s100 * (1 - uz) + s101 * uz
    a11 = s110 * (1 - uz) + s111 * uz

    b00 = s001 - s000
    b01 = s011 - s010
    b10 = s101 - s100
    b11 = s111 - s110

    c0 = a00 * (1 - uy) + a01 * uy
    c1 = a10 * (1 - uy) + a11 * uy

    d0 = -(a00 * vy - vz * b00 * (1 - uy)) + (a01 * vy + vz * b01 * uy)
    d1 = -(a10 * vy - vz * b10 * (1 - uy)) + (a11 * vy + vz * b11 * uy)

    e0 = vy * vz * (b01 - b00)
    e1 = vy * vz * (b11 - b10)

    f3 = (e1 - e0) * vx
    f2 = -d0 * vx + e0 * (1 - ux) + d1 * vx + e1 * ux
    f1 = -c0 * vx + d0 * (1 - ux) + c1 * vx + d1 * ux
    f0 = c0 * (1 - ux) + c1 * ux
    return f0, f1, f2, f3


def _where(c, a, b):
    """``torch.where`` that accepts python scalars on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(c, a, b)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as a true division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which rounds otherwise than the kernels' division (samples.cuh)."""
    return x / torch.full_like(x, c)


def _cubic_roots_raw(f0, f1, f2, f3):
    """Closed-form real roots with two clamped Newton steps; the root axis
    is LEADING: returns (roots (3, ...), has (3, ...)), NO_ROOT where a slot
    holds no root. Branches as svox2.py:2078-2158 (degenerate linear and
    quadratic at atol 1e-10, trigonometric three-root case, Cardano one-root
    case); ascending root order within a quadratic/cubic triple."""
    is3 = torch.abs(f3) >= _ATOL
    is2 = ~is3 & (torch.abs(f2) >= _ATOL)
    is1 = ~is3 & ~is2 & (torch.abs(f1) >= _ATOL)

    # ---- linear: f1 t + f0 = 0
    t_lin = -f0 / _where(is1, f1, 1.0)

    # ---- quadratic: f2 t^2 + f1 t + f0 = 0
    qb = _where(is2, f2, 1.0)
    D = f1 * f1 - 4.0 * f2 * f0
    has2 = is2 & (D > 0)
    sqrtD = torch.sqrt(_where(has2, D, 0.0))
    q0 = (-f1 - sqrtD) / (2.0 * qb)
    q1 = (-f1 + sqrtD) / (2.0 * qb)
    t_q0 = torch.minimum(q0, q1)
    t_q1 = torch.maximum(q0, q1)

    # ---- cubic (normalized): t^3 + b t^2 + c t + d = 0
    cf3 = _where(is3, f3, 1.0)
    b = f2 / cf3
    c = f1 / cf3
    d = f0 / cf3
    Q = _div(b * b - 3.0 * c, 9.0)
    R = _div(2.0 * (b * b * b) - 9.0 * b * c + 27.0 * d, 54.0)

    three_real = is3 & (R * R < Q * Q * Q)
    Qs = _where(three_real, Q, 1.0)
    sqrtQ = torch.sqrt(Qs)
    arg = torch.clamp(R / (sqrtQ * sqrtQ * sqrtQ), -1.0 + _EPS, 1.0 - _EPS)
    theta = torch.arccos(arg)
    pi = math.pi
    t_c0 = -2.0 * sqrtQ * torch.cos(_div(theta, 3.0)) - _div(b, 3.0)
    t_c1 = -2.0 * sqrtQ * torch.cos(_div(theta - 2.0 * pi, 3.0)) - _div(b, 3.0)
    t_c2 = -2.0 * sqrtQ * torch.cos(_div(theta + 2.0 * pi, 3.0)) - _div(b, 3.0)

    one_real = is3 & ~three_real
    disc = _where(one_real, R * R - Q * Q * Q, 1.0)
    A = -torch.sign(R) * torch.pow(torch.abs(R) + torch.sqrt(torch.clamp(disc, min=1e-8)), 1.0 / 3.0)
    Bv = _where(A == 0.0, 0.0, Q / _where(A == 0.0, 1.0, A))
    t_s = A + Bv - _div(b, 3.0)

    zero = torch.zeros_like(f0)
    r0 = torch.where(
        three_real, t_c0,
        torch.where(one_real, t_s, torch.where(has2, t_q0, torch.where(is1, t_lin, zero))),
    )
    r1 = torch.where(three_real, t_c1, torch.where(has2, t_q1, zero))
    r2 = torch.where(three_real, t_c2, zero)
    roots = torch.stack([r0, r1, r2], dim=0)
    has = torch.stack(
        [three_real | one_real | has2 | is1, three_real | has2, three_real], dim=0
    )
    # two clamped Newton steps, skipped near f' ~ 0 (cubic.py:170-185)
    F0, F1, F2, F3 = f0[None], f1[None], f2[None], f3[None]
    for _ in range(2):
        ft = ((F3 * roots + F2) * roots + F1) * roots + F0
        fp = (3.0 * F3 * roots + 2.0 * F2) * roots + F1
        ok = torch.abs(fp) > 1e-6
        step = torch.where(ok, ft / _where(ok, fp, 1.0), torch.zeros_like(ft))
        roots = roots - torch.clamp(step, -0.5, 0.5)
    has = has & (torch.abs(roots) < _ROOT_MAX)
    return _where(has, roots, NO_ROOT), has


class _CubicRootsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, f2, f3):
        roots, has = _cubic_roots_raw(f0, f1, f2, f3)
        ctx.save_for_backward(f1, f2, f3, roots, has)
        return roots

    @staticmethod
    def backward(ctx, g):
        f1, f2, f3, roots, has = ctx.saved_tensors
        ts = torch.where(has, roots, torch.zeros_like(roots))
        fp = 3.0 * f3[None] * ts * ts + 2.0 * f2[None] * ts + f1[None]
        # |f'| < eps becomes sign(f') * eps, and eps where f' == 0 (double roots)
        small = torch.abs(fp) < _EPS
        fp_safe = torch.where(small, torch.sign(fp) * _EPS + (fp == 0).to(fp.dtype) * _EPS, fp)
        gt = torch.where(has, -g / fp_safe, torch.zeros_like(g))
        return (gt.sum(0), (gt * ts).sum(0), (gt * ts * ts).sum(0), (gt * ts * ts * ts).sum(0))


def cubic_roots_T(f0, f1, f2, f3) -> torch.Tensor:
    """Real roots of f3 t^3 + f2 t^2 + f1 t + f0 = 0, shape (3, ...);
    slots without a real root hold NO_ROOT (-1). Differentiable in the
    coefficients by the implicit-differentiation rule (module docstring)."""
    return _CubicRootsT.apply(f0, f1, f2, f3)
