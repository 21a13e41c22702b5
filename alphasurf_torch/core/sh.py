"""Real spherical-harmonic basis (degrees 0..4), the counterpart of
the JAX package's ``core.sh`` (svox2 ``utils.py:eval_sh_bases``)."""
from __future__ import annotations

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


def eval_basis(grid, viewdirs: torch.Tensor) -> torch.Tensor:
    """Per-ray basis. Only the SH basis is ported; the learned 3D-texture
    and MLP bases wait for ROADMAP §1 item 2b."""
    if grid.basis_type != defs.BASIS_TYPE_SH:
        raise NotImplementedError(
            f"basis_type {grid.basis_type} is not ported yet (ROADMAP §1 item 2b)"
        )
    return eval_sh_bases(grid.basis_dim, viewdirs)


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
