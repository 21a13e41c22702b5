"""Ray batches and pinhole cameras, the counterpart of
the JAX package's ``core.rays`` (svox2's ``Rays``/``Camera``, svox2.py:108-237).
OpenCV convention. NDC cameras are not ported yet (ROADMAP §1 item 4)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device


@dataclasses.dataclass
class Rays:
    origins: torch.Tensor  # (B, 3)
    dirs: torch.Tensor  # (B, 3)
    masks: torch.Tensor | None = None  # (B,) bool: rays the image loss counts


@dataclasses.dataclass(frozen=True)
class Camera:
    c2w: np.ndarray  # (4, 4) or (3, 4) float32, OpenCV convention
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 800
    height: int = 800

    @classmethod
    def make(cls, c2w, fx, fy=None, cx=None, cy=None, width=800, height=800):
        fy = fx if fy is None else fy
        cx = width * 0.5 if cx is None else cx
        cy = height * 0.5 if cy is None else cy
        f32 = np.float32
        return cls(
            c2w=np.asarray(c2w, dtype=f32),
            fx=float(f32(fx)),
            fy=float(f32(fy)),
            cx=float(f32(cx)),
            cy=float(f32(cy)),
            width=int(width),
            height=int(height),
        )

    def gen_rays(self, device="cuda") -> Rays:
        """All pixel rays, computed on the host in float64 and returned as
        float32 (svox2.py:211-237)."""
        dev = resolve_device(device)
        c2w = np.asarray(self.c2w, dtype=np.float64)
        yy, xx = np.meshgrid(
            np.arange(self.height, dtype=np.float64) + 0.5,
            np.arange(self.width, dtype=np.float64) + 0.5,
            indexing="ij",
        )
        xx = (xx - self.cx) / self.fx
        yy = (yy - self.cy) / self.fy
        dirs = np.stack((xx, yy, np.ones_like(xx)), axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = (c2w[None, None, :3, :3] @ dirs[..., None])[..., 0]
        dirs = dirs.reshape(-1, 3).astype(np.float32)
        # C order: astype keeps the broadcast view's column-major layout,
        # and the kernels take contiguous rays only
        origins = np.ascontiguousarray(
            np.broadcast_to(c2w[None, :3, 3], (self.height * self.width, 3)), dtype=np.float32)
        return Rays(torch.as_tensor(origins, device=dev), torch.as_tensor(dirs, device=dev))

    def gen_rays_device(self, device="cuda") -> Rays:
        """``gen_rays`` computed on ``device`` in float32 throughout, as
        the JAX package's ``Camera.gen_rays_device``."""
        dev = resolve_device(device)
        f32 = torch.float32
        H, W = self.height, self.width
        c2w = torch.as_tensor(self.c2w, dtype=f32, device=dev)
        yy, xx = torch.meshgrid(
            torch.arange(H, dtype=f32, device=dev) + 0.5,
            torch.arange(W, dtype=f32, device=dev) + 0.5,
            indexing="ij",
        )
        x = (xx - self.cx) / self.fx
        y = (yy - self.cy) / self.fy
        dirs = torch.stack([x, y, torch.ones_like(x)], -1)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        dirs = torch.einsum("ij,hwj->hwi", c2w[:3, :3], dirs).reshape(-1, 3)
        origins = c2w[:3, 3].expand(H * W, 3).contiguous()
        return Rays(origins, dirs.contiguous())
