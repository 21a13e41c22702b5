"""Per-ray colour bases, the counterpart of the JAX package's ``core.sh``:
the real spherical-harmonic basis (degrees 0..4, svox2 ``utils.py:
eval_sh_bases``) and the two learned bases of svox2 (``svox2.py:
6404-6499``): a 3D texture of basis values trilerped at the direction in
the cube, and a small MLP on the positionally encoded direction. Both are
plain PyTorch ops on the grid's device, as svox2 computed them in PyTorch
too; their gradients reach the renderers' ``sh_mult`` input."""
from __future__ import annotations

import numpy as np
import torch

from .. import defs

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


MLP_POSENC_DEG = 4  # mlp_posenc_size default (svox2.py:649)


def eval_learned_basis(basis_data: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The learned 3D-texture basis: ``basis_data`` (R, R, R, bd) trilerped
    at the unit direction embedded in the cube (sh.py:45; svox2.py:6404-6410).
    The position is clipped to [0, R-1] before it is truncated, and the base
    voxel to R-2, so the upper face takes the last voxel at fraction 1."""
    R, bd = basis_data.shape[0], basis_data.shape[-1]
    pos = (dirs * 0.5 + 0.5) * (R - 1)
    pos = torch.clamp(pos, 0.0, R - 1)
    l = torch.clamp(pos.to(torch.int32), 0, R - 2)
    f = pos - l.to(pos.dtype)
    # the corners' flat cell ids; index_select gathers (and its gradient
    # adds) rows, as fast as JAX's gather on the card
    base = ((l[..., 0].long() * R + l[..., 1].long()) * R + l[..., 2].long()).reshape(-1)
    rows = basis_data.reshape(-1, bd)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                corner = torch.index_select(rows, 0, base + (dx * R + dy) * R + dz)
                out = out + w[..., None] * corner.reshape(*w.shape, bd)
    return out


def posenc(x: torch.Tensor, num_freqs: int, include_identity: bool = True) -> torch.Tensor:
    """NeRF positional encoding (sh.py:69; svox2/utils.py:496-513): (..., D)
    -> (..., D (2 num_freqs [+ 1])), laid out as x, then for each octave f
    sin(2^f x) followed by cos(2^f x)."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # (..., F, D)
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*x.shape[:-1], -1)
    if include_identity:
        enc = torch.cat([x, enc], dim=-1)
    return enc


class BasisMLP(torch.nn.Module):
    """The learned-basis MLP (BASIS_TYPE_MLP, svox2.py:963-976): posenc(dir)
    -> hidden -> relu -> basis_dim. Its parameters ``w0`` (in, hidden),
    ``b0`` (hidden,), ``w1`` (hidden, bd), ``b1`` (bd,) keep the JAX
    package's (in, out) layout and names, so that checkpoints
    (``basis_mlp.w0`` ...) and the JAX dict map one to one. Frozen, as the
    grid's other rows; a train step unfreezes them."""

    KEYS = ("w0", "b0", "w1", "b1")

    def __init__(self, w0, b0, w1, b1):
        super().__init__()
        for k, v in zip(self.KEYS, (w0, b0, w1, b1)):
            setattr(self, k, torch.nn.Parameter(v, requires_grad=False))

    @classmethod
    def from_dict(cls, d: dict, device=None, dtype=None) -> "BasisMLP":
        """From a dict of the four arrays (numpy or tensors), copied."""
        return cls(*(torch.tensor(np.asarray(d[k]), device=device, dtype=dtype)
                     if not torch.is_tensor(d[k]) else d[k].to(device=device, dtype=dtype,
                                                               copy=True)
                     for k in cls.KEYS))

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).detach().cpu().numpy() for k in self.KEYS}

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in self.KEYS}


def init_basis_mlp(generator: torch.Generator, basis_dim: int, hidden: int = 64,
                   posenc_deg: int = MLP_POSENC_DEG, device="cpu",
                   dtype=torch.float32) -> BasisMLP:
    """The MLP's parameters at the JAX package's He scales (sh.py:86):
    normal weights times sqrt(2 / fan_in), zero biases, drawn from
    ``generator`` (a CPU ``torch.Generator``; its numbers are not
    ``jax.random``'s)."""
    in_dim = 3 * (2 * posenc_deg + 1)
    w0 = torch.randn((in_dim, hidden), generator=generator, dtype=torch.float32)
    w1 = torch.randn((hidden, basis_dim), generator=generator, dtype=torch.float32)
    f = dict(device=device, dtype=dtype)
    return BasisMLP((w0 * (2.0 / in_dim) ** 0.5).to(**f), torch.zeros(hidden, **f),
                    (w1 * (2.0 / hidden) ** 0.5).to(**f), torch.zeros(basis_dim, **f))


def eval_basis_mlp(params, dirs: torch.Tensor, posenc_deg: int = MLP_POSENC_DEG) -> torch.Tensor:
    """The MLP at unit directions (sh.py:104; svox2.py:6412-6424): (..., 3)
    -> (..., basis_dim). ``params``: a ``BasisMLP`` or a dict of its four
    tensors. The two products are plain matrix products (full float32 on
    the card: TF32 stays off, PyTorch's default for matmul); the ReLU is
    ``jnp.maximum``'s, half the gradient at an exact tie."""
    p = params.tensors() if isinstance(params, BasisMLP) else params
    h = posenc(dirs, posenc_deg)
    h = h @ p["w0"] + p["b0"]
    h = torch.maximum(h, torch.zeros((), dtype=h.dtype, device=h.device))
    return h @ p["w1"] + p["b1"]


def eval_basis(grid, viewdirs: torch.Tensor) -> torch.Tensor:
    """The per-ray basis (sh.py:112; svox2.py:3415-3426): the 3D texture
    when the grid is BASIS_TYPE_3D_TEXTURE and holds ``basis_data``, the MLP
    when it is BASIS_TYPE_MLP and holds ``basis_mlp``, else the SH basis
    (a texture grid without its texture evaluates SH, as JAX's does)."""
    if grid.basis_type == defs.BASIS_TYPE_3D_TEXTURE and grid.basis_data is not None:
        return eval_learned_basis(grid.basis_data, viewdirs)
    if grid.basis_type == defs.BASIS_TYPE_MLP and grid.basis_mlp is not None:
        return eval_basis_mlp(grid.basis_mlp, viewdirs)
    return eval_sh_bases(grid.basis_dim, viewdirs)


def reinit_learned_bases(basis_reso: int, basis_dim: int, init_type: str = "sh",
                         upper_hemi: bool = False, sg_lambda_max: float = 1.0, seed: int = 0,
                         device="cpu") -> torch.Tensor:
    """The learned 3D texture initialised with an analytic spherical basis
    on the direction cube (sh.py:124; svox2.py:6426-6499): ``init_type``
    "sh", "sg" (spherical Gaussians at Fibonacci-spiral means) or "fourier"
    (random-frequency Fourier features). The random draws are numpy's
    ``default_rng(seed)`` in JAX's order, so the values are JAX's. Returns
    (R, R, R, basis_dim) float32 on ``device``."""
    R = basis_reso
    ax = (np.arange(R, dtype=np.float64) + 0.5) / R * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    dirs = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs / np.maximum(norm, 1e-8)
    if upper_hemi:
        dirs[..., 2] = np.abs(dirs[..., 2])
    d = torch.as_tensor(dirs.astype(np.float32))
    if init_type == "sh":
        vals = eval_sh_bases(basis_dim, d)
    elif init_type == "sg":
        rng = np.random.default_rng(seed)
        i = np.arange(basis_dim, dtype=np.float64) + 0.5
        phi = np.arccos(1 - 2 * i / basis_dim)
        theta = np.pi * (1 + 5**0.5) * i
        mu = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                      axis=-1)
        lam = rng.uniform(0.5, sg_lambda_max, basis_dim)
        vals = torch.exp(torch.as_tensor(lam.astype(np.float32))
                         * (d @ torch.as_tensor(mu.T.astype(np.float32)) - 1.0))
    elif init_type == "fourier":
        rng = np.random.default_rng(seed)
        freqs = rng.normal(size=(3, basis_dim)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, basis_dim).astype(np.float32)
        vals = torch.cos(d @ torch.as_tensor(freqs) + torch.as_tensor(phase))
    else:
        raise ValueError(f"unknown basis init {init_type!r}")
    return vals.reshape(R, R, R, basis_dim).to(device=device, dtype=torch.float32)


def eval_sh_bases(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH bases at unit directions: (..., 3) -> (..., basis_dim)."""
    comps = [torch.full(dirs.shape[:-1], SH_C0, dtype=dirs.dtype, device=dirs.device)]
    if basis_dim > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        comps += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if basis_dim > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            comps += [
                SH_C2[0] * xy,
                SH_C2[1] * yz,
                SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz,
                SH_C2[4] * (xx - yy),
            ]
            if basis_dim > 9:
                comps += [
                    SH_C3[0] * y * (3 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4 * zz - xx - yy),
                    SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    SH_C3[4] * x * (4 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3 * yy),
                ]
                if basis_dim > 16:
                    comps += [
                        SH_C4[0] * xy * (xx - yy),
                        SH_C4[1] * yz * (3 * xx - yy),
                        SH_C4[2] * xy * (7 * zz - 1),
                        SH_C4[3] * yz * (7 * zz - 3),
                        SH_C4[4] * (zz * (35 * zz - 30) + 3),
                        SH_C4[5] * xz * (7 * zz - 3),
                        SH_C4[6] * (xx - yy) * (7 * zz - 1),
                        SH_C4[7] * xz * (xx - 3 * yy),
                        SH_C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                    ]
    return torch.stack(comps[:basis_dim], dim=-1)
