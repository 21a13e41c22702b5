"""Trilinear corner weights and the lattice clamp, the counterpart of the JAX
package's ``ops.trilerp`` (svox2 render_util.cuh:73-157)."""
from __future__ import annotations

import torch


def trilerp_weights_T(posT: torch.Tensor) -> torch.Tensor:
    """Corner weights for fractional positions, component and corner axes
    leading: (3, ...) -> (8, ...) in reference corner order (z fastest)."""
    x, y, z = posT[0], posT[1], posT[2]
    ix, iy, iz = 1.0 - x, 1.0 - y, 1.0 - z
    return torch.stack(
        [
            ix * iy * iz,
            ix * iy * z,
            ix * y * iz,
            ix * y * z,
            x * iy * iz,
            x * iy * z,
            x * y * iz,
            x * y * z,
        ],
        dim=0,
    )


def voxel_of(pos: torch.Tensor, reso) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp grid-space positions (..., 3) into the lattice and split them
    into (voxel base l, int32; fraction), as the JAX package's ``voxel_of``
    (trilerp.py:74, svox2.py:1271-1283)."""
    hi = torch.tensor([r - 1 for r in reso], dtype=pos.dtype, device=pos.device)
    pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
    lmax = torch.tensor([r - 2 for r in reso], dtype=torch.int32, device=pos.device)
    l = torch.minimum(torch.clamp(pos.to(torch.int32), min=0), lmax)
    return l, pos - l.to(pos.dtype)
