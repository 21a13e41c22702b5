"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source has a plain-C entry point returning ``cudaError_t``. It is
compiled by ``nvcc`` at first use into ``build/kernels`` at the repository
root (one shared library per source, named by a hash of the sources and
flags, all sources compiled in parallel) and loaded with ``ctypes``. The
wrappers here check device, dtype, shape and contiguity, allocate outputs
with ``torch.empty``, launch on the current stream, raise on a non-zero
return and count the launch in ``LAUNCHES``.

Nothing here runs when the module is imported: the CPU tests import it on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import defs
from .core.grid import UDF_TYPES

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("occupancy", "phase_a", "phase_b", "composite", "backward", "reg", "rmsprop", "cuvol",
           "topology", "sweep", "extract", "background", "compat")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

# launches per kernel; only the wrappers below add to them
LAUNCHES = {
    "occupancy": 0,
    "phase_a_count": 0,
    "phase_a_fill": 0,
    "phase_b": 0,
    "composite": 0,
    "composite_sigma_thresh": 0,
    "intersect_points": 0,
    "backward_ray": 0,
    "backward_entry": 0,
    "backward_entry_basis": 0,
    "reg_tv": 0,
    "reg_normal": 0,
    # K6's every-cell mode (a launch also counts under the kernel's name)
    "reg_tv_every": 0,
    "reg_normal_every": 0,
    "reg_sparsify": 0,
    "rmsprop": 0,
    "density_occupancy": 0,
    "cuvol_forward": 0,
    "cuvol_backward": 0,
    "cuvol_backward_basis": 0,
    "cuvol_backward_out": 0,
    "cuvol_march": 0,
    "cuvol_march_backward": 0,
    "keep_mask": 0,
    "prune_mask": 0,
    "lv_band": 0,
    "resample_dense": 0,
    "resample_rows": 0,
    "weight_march": 0,
    "visibility": 0,
    "transmit_march": 0,
    "mask_march": 0,
    "iso_points": 0,
    "dense_walk_count": 0,
    "dense_walk_fill": 0,
    "compact_fill": 0,
    "composite_cache": 0,
    "backward_cache": 0,
    "reg_norm_match": 0,
    "reg_viscosity": 0,
    "reg_sign_change": 0,
    "reg_eikonal": 0,
    "reg_lumisphere": 0,
    "reg_background_tv": 0,
    "reg_basis_tv": 0,
    "background_forward": 0,
    "background_backward": 0,
    "compat_forward_nvol": 0,
    "compat_forward_svox1": 0,
    "compat_backward_nvol": 0,
    "compat_backward_svox1": 0,
    # the output cotangents (a launch also counts under the kernel's name)
    "backward_ray_out": 0,
    "backward_entry_out": 0,
    "compat_backward_out_nvol": 0,
    "compat_backward_out_svox1": 0,
    # return_samples on the card: K11a's walk steps, K4's truncated alphas
    "dense_walk_fill_steps": 0,
    "composite_samples": 0,
}
# the surface types' branches of K1, K3 and K5b (a launch on such a grid
# also counts as "<kernel>_<type>"), and the sparsifier's launches on a
# density table shorter than the surface rows (UDF_ALPHA's)
TYPE_NAMES = {defs.SURFACE_TYPE_PLANE: "plane", defs.SURFACE_TYPE_UDF: "udf",
              defs.SURFACE_TYPE_UDF_ALPHA: "udf_alpha",
              defs.SURFACE_TYPE_UDF_FAKE_SAMPLE: "udf_fake_sample",
              defs.SURFACE_TYPE_VOXEL_FACE: "voxel_face"}
for _k in ("occupancy", "phase_b", "backward_entry", "backward_entry_out"):
    LAUNCHES.update({f"{_k}_{_t}": 0 for _t in TYPE_NAMES.values()})
LAUNCHES["reg_sparsify_table"] = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "occupancy_words": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P],
    "phase_a_count": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "phase_a_fill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "compact_fill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dense_walk_count": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "dense_walk_fill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "phase_b": [_P, _P, _P, _P, _L, _P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _I,
                _I, _I, _P, _F, _F, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                _P],
    "composite": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _F, _I, _F, _F, _P,
                  _I,
                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P],
    "intersect_points": [_P, _P, _P, _P, _I, _L, _F, _F, _F, _F, _F, _F, _P, _P],
    "backward_ray": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _I, _P, _F, _I, _F, _F, _P, _I, _P,
                     _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "backward_entry": [_P, _P, _P, _P, _L, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P,
                       _I, _I, _I, _P, _F, _F, _P, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "reg_tv": [_P, _I, _I, _I, _P, _P, _L, _P, _L, _I, _I, _I, _P, _L, _F, _F, _P, _P, _P],
    "reg_normal": [_P, _I, _I, _I, _P, _P, _L, _P, _I, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    "reg_sparsify": [_P, _I, _I, _I, _P, _L, _P, _L, _P, _I, _F, _F, _F, _F, _F, _P, _P, _P,
                     _P],
    "reg_ext": [_I, _P, _I, _I, _I, _P, _L, _I, _P, _I, _P, _L, _P, _F, _F, _F, _P, _P, _P, _P,
                _I, _P, _F, _P, _P],
    "reg_background_tv": [_P, _I, _I, _P, _I, _P, _L, _F, _F, _F, _P, _P, _P],
    "reg_basis_tv": [_P, _I, _I, _F, _P, _P, _P],
    "rmsprop": [_P, _P, _P, _L, _I, _F, _F, _F, _F, _I, _F, _I, _F, _I, _P],
    "density_occupancy_words": [_P, _P, _I, _I, _I, _P, _P],
    "cuvol_forward": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F,
                      _I, _I, _F, _P, _I, _F, _P, _P, _P, _P, _P, _P],
    "cuvol_backward": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F,
                       _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "cuvol_march": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _I, _I, _F, _P,
                    _I, _F, _P, _P, _P, _P, _P, _P],
    "cuvol_march_backward": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _I, _I,
                             _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "topo_window_or": [_P, _F, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "topo_prune_valid": [_P, _P, _P, _F, _I, _I, _I, _P, _P],
    "topo_straddle": [_P, _I, _I, _I, _P, _I, _P, _P],
    "topo_resample_dense": [_P, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P, _P],
    "topo_resample_rows": [_P, _I, _I, _P, _I, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _P, _P, _P],
    "weight_march": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _F, _I, _P, _P],
    "visibility": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    "transmit_march": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P],
    "mask_march": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _P, _P],
    "iso_points": [_P, _I, _P, _I, _I, _I, _P, _P, _F, _F, _I, _P, _P],
    "background_forward": [_P, _P, _P, _I, _F, _F, _F, _P, _I, _P, _I, _I, _I, _F, _P, _P, _P],
    "background_backward": [_P, _P, _P, _I, _F, _F, _F, _P, _I, _P, _I, _I, _I, _F, _P, _P, _P,
                            _P, _P],
    "compat_forward": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _I, _F, _F,
                       _P, _P, _P, _P],
    "compat_backward": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _I, _F, _F,
                        _P, _P, _P, _P, _P, _P, _P],
}
_FUNCS = {
    "occupancy": ("occupancy_words", "density_occupancy_words"),
    "phase_a": ("phase_a_count", "phase_a_fill", "compact_fill", "dense_walk_count",
                "dense_walk_fill"),
    "phase_b": ("phase_b",),
    "composite": ("composite", "intersect_points"),
    "backward": ("backward_ray", "backward_entry"),
    "reg": ("reg_tv", "reg_normal", "reg_sparsify", "reg_ext", "reg_background_tv",
            "reg_basis_tv"),
    "rmsprop": ("rmsprop",),
    "cuvol": ("cuvol_forward", "cuvol_backward", "cuvol_march", "cuvol_march_backward"),
    "topology": ("topo_window_or", "topo_prune_valid", "topo_straddle", "topo_resample_dense",
                 "topo_resample_rows"),
    "sweep": ("weight_march", "visibility", "transmit_march", "mask_march"),
    "extract": ("iso_points",),
    "background": ("background_forward", "background_backward"),
    "compat": ("compat_forward", "compat_backward"),
}

_libs: dict = {}
BUILD_LOG: dict = {}  # source -> {"seconds": s, "ptxas": [...lines]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together; load them all. Returns BUILD_LOG."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if name in _libs or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
        os.replace(tmp, out)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln or "entry function" in ln],
        }
    for name in SOURCES:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn in _FUNCS[name]:
                f = getattr(lib, fn)
                f.argtypes = _ARGTYPES[fn]
                f.restype = ctypes.c_int
            _libs[name] = lib
    return BUILD_LOG


def _fn(lib: str, fn: str):
    if lib not in _libs:
        build()
    return getattr(_libs[lib], fn)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(lib: str, fn: str, counter: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with cudaError_t {err}")
    LAUNCHES[counter] += 1


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def occupancy(links, density, surface, level_sets, sigma_thresh: float, hull: bool,
              stype: int = defs.SURFACE_TYPE_SDF):
    """K1: (X-1, Y-1, ceil((Z-1)/32)) int32 occupancy words. ``density``
    (cap,) raw alphas, or (1,), one value every corner reads (UDF_ALPHA's
    largest alpha); ``surface`` (cap,) or (cap, C), channel 0 read; ``hull``
    the level-set hull test (the render options decide it). ``stype``, the
    grid's surface type: the UDF types test the softplus of their surface
    values, and a launch on another type than SDF also counts as
    ``occupancy_<type>``."""
    X, Y, Z = links.shape
    _check("links", links, torch.int32)
    cap = surface.shape[0]
    n_surf_c = 1 if surface.dim() == 1 else surface.shape[1]
    _check("surface", surface, torch.float32)
    _check("density", density, torch.float32)
    if density.shape not in ((cap,), (1,)):
        raise ValueError(f"density: expected shape ({cap},) or (1,), got {tuple(density.shape)}")
    _check("level_sets", level_sets, torch.float32)
    words = torch.empty((X - 1, Y - 1, (Z - 1 + 31) // 32), dtype=torch.int32, device=links.device)
    if words.numel() == 0:
        return words
    _launch("occupancy", "occupancy_words", "occupancy",
            _ptr(links), _ptr(density), 0 if density.shape[0] == 1 and cap > 1 else 1,
            _ptr(surface), n_surf_c, _ptr(level_sets), level_sets.numel(), X, Y, Z,
            float(sigma_thresh), int(hull), int(stype in UDF_TYPES), _ptr(words))
    _count_type("occupancy", stype)
    return words


def _count_type(kernel: str, stype: int) -> None:
    """Count a launch on a grid of another surface type than SDF."""
    if stype in TYPE_NAMES:
        LAUNCHES[f"{kernel}_{TYPE_NAMES[stype]}"] += 1


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _phase_a_inputs(origins, dirs, tnear, tmax, words, reso):
    B = origins.shape[0]
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    _check("tnear", tnear, torch.float32, (B,))
    _check("tmax", tmax, torch.float32, (B,))
    X, Y, Z = reso
    _check("occupancy words", words, torch.int32, (X - 1, Y - 1, (Z - 1 + 31) // 32))
    return B, (_ptr(origins), _ptr(dirs), _ptr(tnear), _ptr(tmax), _ptr(words), B, X, Y, Z)


def phase_a_count(origins, dirs, tnear, tmax, words, reso):
    """K2 count pass: per-ray (n_occupied, n_entries), both (B,) int32."""
    B, args = _phase_a_inputs(origins, dirs, tnear, tmax, words, reso)
    n_occ = torch.empty(B, dtype=torch.int32, device=origins.device)
    n_valid = torch.empty(B, dtype=torch.int32, device=origins.device)
    if B > 0:
        _launch("phase_a", "phase_a_count", "phase_a_count", *args, _ptr(n_occ), _ptr(n_valid))
    return n_occ, n_valid


def phase_a_fill(origins, dirs, tnear, tmax, words, reso, offsets, M: int):
    """K2 fill pass: the pool (ray_id (M,), l (M, 3), close_t, far_t) with
    ray r's entries at [offsets[r], offsets[r+1])."""
    B, args = _phase_a_inputs(origins, dirs, tnear, tmax, words, reso)
    _check("offsets", offsets, torch.int64, (B + 1,))
    pool = _empty_pool(M, origins.device)
    if M > 0:  # an empty pool launches nothing
        _launch("phase_a", "phase_a_fill", "phase_a_fill", *args, _ptr(offsets),
                *(_ptr(x) for x in pool))
    return pool


def _empty_pool(M: int, dev):
    """Uninitialised pool arrays (ray_id, l, close_t, far_t) of M entries."""
    return (torch.empty(M, dtype=torch.int32, device=dev),
            torch.empty((M, 3), dtype=torch.int32, device=dev),
            torch.empty(M, dtype=torch.float32, device=dev),
            torch.empty(M, dtype=torch.float32, device=dev))


def compact_fill(origins, dirs, tnear, tmax, words, reso, offsets, M: int):
    """K11b: K2's fill capped at each ray's end offset: with offsets from
    the scan of min(n_valid, K), each ray's first K entries."""
    B, args = _phase_a_inputs(origins, dirs, tnear, tmax, words, reso)
    _check("offsets", offsets, torch.int64, (B + 1,))
    pool = _empty_pool(M, origins.device)
    if M > 0:
        _launch("phase_a", "compact_fill", "compact_fill", *args, _ptr(offsets),
                *(_ptr(x) for x in pool))
    return pool


def _dense_inputs(origins, dirs, t0, tmax, ray_ok, words, reso, max_voxels: int):
    B, args = _phase_a_inputs(origins, dirs, t0, tmax, words, reso)
    _check("ray_ok", ray_ok, torch.bool, (B,))
    p_o, p_d, p_t0, p_tx, p_w, _, X, Y, Z = args
    return B, (p_o, p_d, p_t0, p_tx, _ptr(ray_ok), p_w, B, X, Y, Z, int(max_voxels))


def dense_walk_count(origins, dirs, t0, tmax, ray_ok, words, reso, max_voxels: int):
    """K11a count pass: per ray (B,) int32 the occupied voxels of its dense
    walk from t0 (tnear where ray_ok, else 0)."""
    B, args = _dense_inputs(origins, dirs, t0, tmax, ray_ok, words, reso, max_voxels)
    n = torch.empty(B, dtype=torch.int32, device=origins.device)
    if B > 0:
        _launch("phase_a", "dense_walk_count", "dense_walk_count", *args, _ptr(n))
    return n


def dense_walk_fill(origins, dirs, t0, tmax, ray_ok, words, reso, max_voxels: int, offsets,
                    M: int, want_steps: bool = False):
    """K11a fill pass: the pool (ray_id, l, close_t, far_t: the voxel's slab)
    with ray r's walk-ordered entries at [offsets[r], offsets[r+1]); with
    ``want_steps`` also each entry's walk step (M,) int32, a fifth output (a
    launch with it also counts as ``dense_walk_fill_steps``)."""
    B, args = _dense_inputs(origins, dirs, t0, tmax, ray_ok, words, reso, max_voxels)
    _check("offsets", offsets, torch.int64, (B + 1,))
    pool = _empty_pool(M, origins.device)
    steps = torch.empty(M, dtype=torch.int32, device=origins.device) if want_steps else None
    if M > 0:
        _launch("phase_a", "dense_walk_fill", "dense_walk_fill", *args, _ptr(offsets),
                *(_ptr(x) for x in pool), _ptr(steps) if want_steps else None)
        if want_steps:
            LAUNCHES["dense_walk_fill_steps"] += 1
    return pool + (steps,) if want_steps else pool


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _scalar_ptr(name: str, x) -> int:
    """Pointer to a one-element float32 tensor on the card (read by the
    kernel, so the host never waits on its value), or 0 for None."""
    if x is None:
        return 0
    _check(name, x, torch.float32)
    if x.numel() != 1:
        raise ValueError(f"{name}: expected one element, got shape {tuple(x.shape)}")
    return _ptr(x)


class SurfaceSpec(NamedTuple):
    """What K3 and K5b read of a grid's surface type: the type (defs'
    values), the surface channels of a row, and UDF_ALPHA's (n_lv,)
    per-level-set alphas (None for the other types)."""

    stype: int
    n_surf_c: int
    lv_alpha: torch.Tensor | None = None


SDF = SurfaceSpec(defs.SURFACE_TYPE_SDF, 1)


def _spec_args(spec: SurfaceSpec, level_sets) -> tuple:
    """(stype, lv_alpha pointer) after checking the table."""
    if (spec.stype == defs.SURFACE_TYPE_UDF_ALPHA) != (spec.lv_alpha is not None):
        raise ValueError("UDF_ALPHA grids, and they only, carry a level-set alpha table")
    if spec.lv_alpha is None:
        return spec.stype, None
    _check("lv_alpha", spec.lv_alpha, torch.float32, (level_sets.numel(),))
    return spec.stype, _ptr(spec.lv_alpha)


def _pool_args(ray_id, l, close_t, far_t, origins, dirs, sh_mult, links, packed, n_surf_c: int,
               level_sets):
    M = close_t.shape[0]
    B = origins.shape[0]
    _check("ray_id", ray_id, torch.int32, (M,))
    _check("l", l, torch.int32, (M, 3))
    _check("close_t", close_t, torch.float32, (M,))
    _check("far_t", far_t, torch.float32, (M,))
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    bd = sh_mult.shape[1]
    _check("sh_mult", sh_mult, torch.float32, (B, bd))
    _check("links", links, torch.int32)
    _check("packed", packed, torch.float32)
    _check("level_sets", level_sets, torch.float32)
    cap, C8 = packed.shape
    if 1 + n_surf_c + 3 * bd > C8:
        raise ValueError(f"packed rows hold {C8} channels, fewer than 1 + {n_surf_c} + 3*{bd}")
    return M, B, bd, cap, C8


def _n_slots(level_sets, opt, stype: int = defs.SURFACE_TYPE_SDF) -> int:
    """S0: one slot for PLANE and VOXEL_FACE, else 3 a level set and the
    fake sample's."""
    if stype in (defs.SURFACE_TYPE_PLANE, defs.SURFACE_TYPE_VOXEL_FACE):
        return 1
    return 3 * level_sets.numel() + (1 if opt.surf_fake_sample else 0)


def _n_loss_e(stype: int) -> int:
    """Rows of K3's per-entry loss sums: the UDF types add udf-var's two."""
    return 5 if stype in UDF_TYPES else 3


def phase_b(ray_id, l, close_t, far_t, origins, dirs, sh_mult, links, packed, spec: SurfaceSpec,
            level_sets, near_grid_t: float, fs_std, opt) -> dict:
    """K3: slot arrays of every pool entry (see render.surface.voxel_samples).
    ``spec`` the grid's ``SurfaceSpec``; ``fs_std`` is the grid's (1, 1)
    fake_sample_std on the card, or None."""
    M, B, bd, cap, C8 = _pool_args(ray_id, l, close_t, far_t, origins, dirs, sh_mult, links,
                                   packed, spec.n_surf_c, level_sets)
    stype, lvp = _spec_args(spec, level_sets)
    fss = _scalar_ptr("fs_std", fs_std)
    n_lv = level_sets.numel()
    S0 = _n_slots(level_sets, opt, stype)
    dev = close_t.device
    out = {
        "t": torch.empty((S0, M), dtype=torch.float32, device=dev),
        "alpha": torch.empty((S0, M), dtype=torch.float32, device=dev),
        "rgb": torch.empty((3, S0, M), dtype=torch.float32, device=dev),
        "contrib": torch.empty((S0, M), dtype=torch.bool, device=dev),
        "fake": torch.empty((S0, M), dtype=torch.bool, device=dev),
        "snorm": torch.empty((3, S0, M), dtype=torch.float32, device=dev),
        "counted": torch.empty((S0, M), dtype=torch.int32, device=dev),
        "loss_e": torch.empty((_n_loss_e(stype), M), dtype=torch.float32, device=dev),
        "n_slots": S0,
    }
    if M > 0:  # an empty pool launches nothing
        X, Y, Z = links.shape
        _launch("phase_b", "phase_b", "phase_b",
                _ptr(ray_id), _ptr(l), _ptr(close_t), _ptr(far_t), M,
                _ptr(origins), _ptr(dirs), _ptr(sh_mult), bd, _ptr(links), X, Y, Z,
                _ptr(packed), cap, C8, spec.n_surf_c, _ptr(level_sets), n_lv, S0, stype, lvp,
                float(near_grid_t), float(opt.sigma_thresh), fss,
                float(opt.surf_fake_sample_min_vox_len), int(opt.only_outward_intersect),
                int(opt.surf_fake_sample), int(opt.limited_fake_sample),
                int(opt.fake_sample_normalize_surf), int(opt.alpha_activation_type == 0),
                *(_ptr(out[k]) for k in ("t", "alpha", "contrib", "fake", "counted", "rgb",
                                         "snorm", "loss_e")))
        _count_type("phase_b", stype)
    return out


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

_SLOT_KEYS = ("t", "alpha", "contrib", "fake", "counted", "rgb")


def _check_slots(smp: dict, S0: int, M: int, keys=_SLOT_KEYS + ("snorm", "loss_e")) -> None:
    for k, dt, shape in (
        ("t", torch.float32, (S0, M)), ("alpha", torch.float32, (S0, M)),
        ("contrib", torch.bool, (S0, M)), ("fake", torch.bool, (S0, M)),
        ("counted", torch.int32, (S0, M)), ("rgb", torch.float32, (3, S0, M)),
        ("snorm", torch.float32, (3, S0, M)),
        ("loss_e", torch.float32, (smp["loss_e"].shape[0] if "loss_e" in smp else 3, M)),
    ):
        if k in keys:
            _check(k, smp[k], dt, shape)
    if "loss_e" in keys and smp["loss_e"].shape[0] not in (3, 5):
        raise ValueError(f"loss_e: expected 3 or 5 rows, got {smp['loss_e'].shape[0]}")


def _composite_opts(opt) -> tuple:
    stop_on = opt.stop_thresh > 0
    return (int(stop_on), float(math.log(opt.stop_thresh) if stop_on else 0.0),
            float(opt.background_brightness), int(opt.fake_sample_l_dist))


def _bg_rgb_ptr(bg_rgb, B: int):
    """The per-ray background colour (K13's ``c_bg``, (B, 3)) or None: the
    kernel then takes the scalar ``background_brightness``."""
    if bg_rgb is None:
        return None
    _check("bg_rgb", bg_rgb, torch.float32, (B, 3))
    return _ptr(bg_rgb)


def composite(offsets, smp: dict, trunc_a, opt, sig_thresh: float | None = None,
              want_live: bool = False, window: int = 0, mode_first: bool = False,
              cache_size: int | None = None, bg_rgb=None, want_live_alpha: bool = False) -> dict:
    """K4: per-ray compositing (see render.surface.composite); ``trunc_a``
    is the grid's truncated_vol_render_a on the card. ``sig_thresh`` adds
    ``depth_sigma_thresh`` (B,) (a launch in that mode also counts as
    ``composite_sigma_thresh``), ``want_live`` the (S0, M) contribution
    flags after the stop_thresh kill. K11c: ``cache_size`` adds the first-K
    ``cache`` (ts, alphas, weights (B, K) float32, fake_mask (B, K) bool,
    n_cached (B,) int32) and its median ``cache_med`` (a launch in that
    mode also counts as ``composite_cache``); ``window`` > 0 adds ``win``
    (M,), the entries inside the count window. ``bg_rgb`` (B, 3), K13's
    per-ray background colour, takes the place of the brightness.
    ``want_live_alpha`` (return_samples) adds ``live_alpha`` (S0, M), each
    live slot's truncated alpha (0 elsewhere), and the live flags (a launch
    in that mode also counts as ``composite_samples``)."""
    B = offsets.shape[0] - 1
    S0, M = smp["t"].shape
    _check("offsets", offsets, torch.int64, (B + 1,))
    _check_slots(smp, S0, M)
    ta = _scalar_ptr("trunc_a", trunc_a)
    dev = offsets.device
    f32 = torch.float32
    out = {
        "rgb": torch.empty((B, 3), dtype=f32, device=dev),
        "depth": torch.empty(B, dtype=f32, device=dev),
        "normal": torch.empty((B, 3), dtype=f32, device=dev),
        "log_T": torch.empty(B, dtype=f32, device=dev),
        "depth_mode": torch.empty(B, dtype=f32, device=dev),
        "depth_med": torch.empty(B, dtype=f32, device=dev),
        "n_intersections": torch.empty(B, dtype=torch.int32, device=dev),
        "ray_losses": torch.empty((12, B), dtype=f32, device=dev),
        "weight": torch.empty((S0, M), dtype=f32, device=dev),
    }
    sig_on = sig_thresh is not None
    if sig_on:
        out["depth_sigma_thresh"] = torch.empty(B, dtype=f32, device=dev)
    want_live = want_live or want_live_alpha
    if want_live:
        out["live"] = torch.empty((S0, M), dtype=torch.bool, device=dev)
    if want_live_alpha:
        out["live_alpha"] = torch.empty((S0, M), dtype=f32, device=dev)
    K = 0 if cache_size is None else int(cache_size)
    cache = None
    if cache_size is not None:
        cache = {"ts": torch.empty((B, K), dtype=f32, device=dev),
                 "alphas": torch.empty((B, K), dtype=f32, device=dev),
                 "weights": torch.empty((B, K), dtype=f32, device=dev),
                 "fake_mask": torch.empty((B, K), dtype=torch.bool, device=dev),
                 "n_cached": torch.empty(B, dtype=torch.int32, device=dev)}
        out["cache"] = cache
        out["cache_med"] = torch.empty(B, dtype=f32, device=dev)
    if window > 0:
        out["win"] = torch.empty(M, dtype=torch.bool, device=dev)
    bgp = _bg_rgb_ptr(bg_rgb, B)
    if B > 0:
        stop_on, log_stop, bg, fake_l_dist = _composite_opts(opt)
        _launch("composite", "composite", "composite",
                _ptr(offsets), B, M, S0,
                *(_ptr(smp[k]) for k in _SLOT_KEYS + ("snorm", "loss_e")), smp["loss_e"].shape[0],
                int(opt.truncated_vol_render), ta, float(opt.trunc_vol_weight_min),
                stop_on, log_stop, bg, bgp, fake_l_dist,
                *(_ptr(out[k]) for k in ("rgb", "depth", "normal", "log_T", "depth_mode",
                                         "depth_med", "n_intersections", "ray_losses",
                                         "weight")),
                int(sig_on), float(sig_thresh) if sig_on else 0.0,
                _ptr(out["depth_sigma_thresh"]) if sig_on else None,
                _ptr(out["live"]) if want_live else None, int(window), int(mode_first), K,
                *((_ptr(cache[k]) for k in ("ts", "alphas", "weights", "fake_mask", "n_cached"))
                  if cache is not None else (None,) * 5),
                _ptr(out["cache_med"]) if cache is not None else None,
                _ptr(out["win"]) if window > 0 else None,
                _ptr(out["live_alpha"]) if want_live_alpha else None)
        if want_live_alpha:
            LAUNCHES["composite_samples"] += 1
        if sig_on:
            LAUNCHES["composite_sigma_thresh"] += 1
        if cache is not None:
            LAUNCHES["composite_cache"] += 1
    return out


def intersect_points(ray_id, t, origins, dirs, rscaling, roffset):
    """The world point (M * S0, 3) float32 of every slot of every pool
    entry, entry-major: o + t d of the entry's ray in grid space, times
    ``rscaling`` plus ``roffset`` (3 floats each, the grid's grid2world)."""
    S0, M = t.shape
    B = origins.shape[0]
    _check("ray_id", ray_id, torch.int32, (M,))
    _check("t", t, torch.float32, (S0, M))
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    pts = torch.empty((M * S0, 3), dtype=torch.float32, device=t.device)
    if M * S0 > 0:
        _launch("composite", "intersect_points", "intersect_points", _ptr(ray_id), _ptr(t),
                _ptr(origins), _ptr(dirs), S0, M, *(float(x) for x in rscaling),
                *(float(x) for x in roffset), _ptr(pts))
    return pts


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

class OutCotangents(NamedTuple):
    """The cotangents of K5a's second instantiation (``backward_ray_out``),
    each float32 on the card or None: per ray (B,) depth, normal (B, 3),
    log_T, the mode depth, the cache-free median ``med`` (the packed
    renderer's), the cache's median ``cache_med`` (the dense and compact
    renderers') and the sigma-thresh depth ``sig``; the intersections'
    points ``pts`` (M S0, 3), entry-major; per slot (S0, M) its ``t``, its
    pre-truncation ``alpha``, its ``weight`` and its truncated alpha where
    it is live (``live_alpha``)."""

    depth: torch.Tensor | None = None
    normal: torch.Tensor | None = None
    log_T: torch.Tensor | None = None
    mode: torch.Tensor | None = None
    med: torch.Tensor | None = None
    cache_med: torch.Tensor | None = None
    sig: torch.Tensor | None = None
    pts: torch.Tensor | None = None
    t: torch.Tensor | None = None
    alpha: torch.Tensor | None = None
    weight: torch.Tensor | None = None
    live_alpha: torch.Tensor | None = None


class _BackRayOut(ctypes.Structure):
    """backward.cu's BackRayOut: K3's normals, the grid-space directions,
    the mode rule, the sigma-thresh depth's threshold, grid2world's scale,
    the output cotangents in OutCotangents' order and d_snorm."""

    _fields_ = ([("snorm", _P), ("dirs", _P), ("mode_first", _I), ("sig_thresh", _F),
                 ("rscale", _F * 3)] + [(f"g_{k}", _P) for k in OutCotangents._fields]
                + [("d_snorm", _P)])


_OUT_SHAPES = {"depth": "B", "normal": "B3", "log_T": "B", "mode": "B", "med": "B",
               "cache_med": "B", "sig": "B", "pts": "P", "t": "S", "alpha": "S", "weight": "S",
               "live_alpha": "S"}


def backward_ray(offsets, smp: dict, trunc_a, opt, g_rgb, g_ray_losses, g_cache=None,
                 bg_rgb=None, out: OutCotangents | None = None, mode_first: bool = False,
                 sig_thresh: float | None = None, rscaling=None, dirs=None):
    """K5a: per-slot cotangents (d_alpha of the pre-truncation alpha (S0, M),
    d_t (S0, M), d_col of the clipped colour (3, S0, M)) from the cotangents
    of rgb (B, 3) and ray_losses (12, B). K11d: ``g_cache``, the cotangents
    (ts, alphas, weights) of K11c's cache, (B, K) each, join them (a launch
    with them also counts as ``backward_cache``). ``bg_rgb``: K13's per-ray
    background colour, as in ``composite``.

    ``out``, the output cotangents (``OutCotangents``): any of them given
    launches the second instantiation (also counted as
    ``backward_ray_out``); it needs K3's
    ``snorm``, the rays' grid-space ``dirs`` (B, 3) and grid2world's
    ``rscaling`` (3 floats) for the points, ``mode_first`` (the walks' mode
    rule) and the forward's ``sig_thresh``. It returns a fourth output,
    d_snorm (3, S0, M), the normal's cotangent for K5b, when ``out.normal``
    is given (else None)."""
    B = offsets.shape[0] - 1
    S0, M = smp["t"].shape
    _check("offsets", offsets, torch.int64, (B + 1,))
    _check_slots(smp, S0, M, _SLOT_KEYS + (("snorm",) if out is not None else ()))
    _check("g_rgb", g_rgb, torch.float32, (B, 3))
    _check("g_ray_losses", g_ray_losses, torch.float32, (12, B))
    ta = _scalar_ptr("trunc_a", trunc_a)
    dev = offsets.device
    d_alpha = torch.empty((S0, M), dtype=torch.float32, device=dev)
    d_t = torch.empty((S0, M), dtype=torch.float32, device=dev)
    d_col = torch.empty((3, S0, M), dtype=torch.float32, device=dev)
    K = 0
    if g_cache is not None:
        K = g_cache[0].shape[1]
        for name, g in zip(("g_cache_ts", "g_cache_alphas", "g_cache_weights"), g_cache):
            _check(name, g, torch.float32, (B, K))
    bgp = _bg_rgb_ptr(bg_rgb, B)
    d_snorm = None
    if out is not None:
        shapes = {"B": (B,), "B3": (B, 3), "P": (M * S0, 3), "S": (S0, M)}
        for name, g in zip(out._fields, out):
            if g is not None:
                _check(f"g_{name}", g, torch.float32, shapes[_OUT_SHAPES[name]])
        if out.cache_med is not None and g_cache is None:
            raise ValueError("backward_ray: the cache median's cotangent needs g_cache")
        if out.pts is not None:
            _check("dirs", dirs, torch.float32, (B, 3))
            if rscaling is None or len(rscaling) != 3:
                raise ValueError("backward_ray: the points' cotangent needs grid2world's rscaling")
        if out.sig is not None and sig_thresh is None:
            raise ValueError("backward_ray: the sigma-thresh depth's cotangent needs sig_thresh")
        if out.normal is not None:
            d_snorm = torch.empty((3, S0, M), dtype=torch.float32, device=dev)
    args = (_ptr(offsets), B, M, S0, *(_ptr(smp[k]) for k in _SLOT_KEYS),
            int(opt.truncated_vol_render), ta, float(opt.trunc_vol_weight_min))
    if B > 0 and M > 0:
        stop_on, log_stop, bg, fake_l_dist = _composite_opts(opt)
        args = (*args, stop_on, log_stop, bg, bgp, fake_l_dist, _ptr(g_rgb), _ptr(g_ray_losses),
                _ptr(d_alpha), _ptr(d_t), _ptr(d_col), K,
                *((_ptr(g) for g in g_cache) if g_cache is not None else (None,) * 3))
        q = None
        if out is not None and any(g is not None for g in out):
            q = _BackRayOut(_ptr(smp["snorm"]), _ptr(dirs) if out.pts is not None else None,
                            int(mode_first), float(sig_thresh) if sig_thresh is not None else 0.0,
                            (_F * 3)(*(rscaling if rscaling is not None else (1.0,) * 3)),
                            *(None if g is None else _ptr(g) for g in out),
                            _ptr(d_snorm) if d_snorm is not None else None)
        _launch("backward", "backward_ray", "backward_ray", *args,
                ctypes.addressof(q) if q is not None else None)
        if q is not None:
            LAUNCHES["backward_ray_out"] += 1
        if g_cache is not None:
            LAUNCHES["backward_cache"] += 1
    if out is None:
        return d_alpha, d_t, d_col
    return d_alpha, d_t, d_col, d_snorm


def backward_entry(ray_id, l, close_t, far_t, origins, dirs, sh_mult, links, packed,
                   spec: SurfaceSpec, level_sets, near_grid_t: float, fs_std, opt, contrib,
                   d_alpha, d_t, d_col, g_ray_losses, win=None, want_sh_mult: bool = False,
                   d_snorm=None):
    """K5b: gradients of the density (cap,) (UDF_ALPHA: of its (n_lv,)
    table), surface (cap, n_surf_c) and SH (cap, 3 bd) rows and of
    fake_sample_std (1,) from K5a's slot cotangents and the inward-norm,
    density-lap and udf-var rows of the ray-loss cotangents, the latter for
    the entries ``win`` (K4's count window; None: all).
    With ``want_sh_mult`` also the gradient of the per-ray basis sh_mult
    (B, bd), a fifth output (a launch with it also counts as
    ``backward_entry_basis``). ``d_snorm`` (3, S0, M), K5a's cotangent of
    each slot's rendered normal, launches the second instantiation
    (``backward_entry_out``, also counted with the type as
    ``backward_entry_out_<type>``), which carries it into the surface rows
    and, through the sample position, the roots."""
    M, B, bd, cap, C8 = _pool_args(ray_id, l, close_t, far_t, origins, dirs, sh_mult, links,
                                   packed, spec.n_surf_c, level_sets)
    stype, lvp = _spec_args(spec, level_sets)
    n_surf_c = spec.n_surf_c
    fss = _scalar_ptr("fs_std", fs_std)
    S0 = _n_slots(level_sets, opt, stype)
    _check("contrib", contrib, torch.bool, (S0, M))
    _check("d_alpha", d_alpha, torch.float32, (S0, M))
    _check("d_t", d_t, torch.float32, (S0, M))
    _check("d_col", d_col, torch.float32, (3, S0, M))
    _check("g_ray_losses", g_ray_losses, torch.float32, (12, B))
    if win is not None:
        _check("win", win, torch.bool, (M,))
    if d_snorm is not None:
        _check("d_snorm", d_snorm, torch.float32, (3, S0, M))
    dev = close_t.device
    g_density = torch.zeros(cap if lvp is None else level_sets.numel(), dtype=torch.float32,
                            device=dev)
    g_surface = torch.zeros((cap, n_surf_c), dtype=torch.float32, device=dev)
    g_sh = torch.zeros((cap, 3 * bd), dtype=torch.float32, device=dev)
    g_fss = torch.zeros(1, dtype=torch.float32, device=dev)
    g_shm = torch.zeros((B, bd), dtype=torch.float32, device=dev) if want_sh_mult else None
    if M > 0:
        X, Y, Z = links.shape
        _launch("backward", "backward_entry", "backward_entry",
                _ptr(ray_id), _ptr(l), _ptr(close_t), _ptr(far_t), M, B,
                _ptr(origins), _ptr(dirs), _ptr(sh_mult), bd, _ptr(links), X, Y, Z,
                _ptr(packed), cap, C8, n_surf_c, _ptr(level_sets), level_sets.numel(), S0,
                stype, lvp, float(near_grid_t), float(opt.sigma_thresh), fss,
                float(opt.surf_fake_sample_min_vox_len), int(opt.only_outward_intersect),
                int(opt.surf_fake_sample), int(opt.limited_fake_sample),
                int(opt.fake_sample_normalize_surf), int(opt.alpha_activation_type == 0),
                int(opt.no_surf_grad_from_sh), _ptr(contrib), _ptr(d_alpha), _ptr(d_t),
                _ptr(d_col), _ptr(g_ray_losses), _ptr(win) if win is not None else None,
                _ptr(g_density), _ptr(g_surface), _ptr(g_sh),
                _ptr(g_fss) if fs_std is not None else 0, _ptr(g_shm) if want_sh_mult else None,
                _ptr(d_snorm) if d_snorm is not None else None)
        if want_sh_mult:
            LAUNCHES["backward_entry_basis"] += 1
        _count_type("backward_entry", stype)
        if d_snorm is not None:
            LAUNCHES["backward_entry_out"] += 1
            _count_type("backward_entry_out", stype)
    out = (g_density, g_surface, g_sh, g_fss)
    return out + (g_shm,) if want_sh_mult else out


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _cells_arg(links, cells):
    _check("links", links, torch.int32)
    if cells is None:
        return 0
    _check("cells", cells, torch.int32)
    return _ptr(cells)


def _rows_arg(cells, row_coords, rows: int):
    """K6's work list: the window ``cells`` (flat ids, int32), or with
    ``cells`` None every lattice cell through ``row_coords`` (rows, 3),
    int32, the lattice coordinates of each data row (reg.row_coords_of).
    Returns the row coordinates' pointer (0 for a window) and the count of
    cells or rows."""
    if cells is not None:
        return 0, cells.numel()
    if row_coords is None:
        raise ValueError("every-cell mode needs row_coords (reg.row_coords_of)")
    _check("row_coords", row_coords, torch.int32, (rows, 3))
    return _ptr(row_coords), rows


# an empty cell's TV per channel, sqrt(1e-5 + 0) in float32
TV_FLOOR = float(np.sqrt(np.float32(1e-5)))


def reg_tv(links, cells, data, c0: int, c1: int, wdens, scale: float, row_coords=None):
    """K6, TV over channels [c0, c1) of ``data`` (rows, C) at ``cells``
    (flat ids, int32) or, with ``cells`` None, at every lattice cell: the
    kernel then visits the present rows of ``row_coords`` (rows, 3) and the
    empty cells add their constant sqrt(1e-5) per channel (times sigmoid(0)
    when weighted) in float64 here. Cells weighted by sigmoid(wdens) when
    ``wdens`` (rows',) is given. A link reads row min(link, rows - 1), as
    fetch_links clips (UDF_ALPHA's density table). Returns the loss (1,),
    summed in float64 and returned as float32, and its gradient (rows, C)."""
    rows, C = data.shape
    _check("data", data, torch.float32)
    cp = _cells_arg(links, cells)
    rp, n = _rows_arg(cells, row_coords, rows)
    if wdens is not None:
        _check("wdens", wdens, torch.float32)
        if wdens.dim() != 1:
            raise ValueError(f"wdens: expected one dimension, got {tuple(wdens.shape)}")
    k_empty = 0.0
    if cells is None:  # float32, as the kernel takes it back for each present cell
        k_empty = float(np.float32(c1 - c0) * np.float32(TV_FLOOR)
                        * np.float32(1.0 if wdens is None else 0.5))
    loss = torch.full((1,), links.numel() * k_empty * scale, dtype=torch.float64,
                      device=data.device)
    grad = torch.zeros_like(data)
    X, Y, Z = links.shape
    if n > 0:
        _launch("reg", "reg_tv", "reg_tv", _ptr(links), X, Y, Z, cp, rp, n, _ptr(data), rows, C,
                c0, c1, 0 if wdens is None else _ptr(wdens), 0 if wdens is None else wdens.numel(),
                float(scale), k_empty, _ptr(loss), _ptr(grad))
        if cells is None:
            LAUNCHES["reg_tv_every"] += 1
    return loss.float(), grad


def reg_normal(links, cells, surface, level_sets, con_check: bool, ignore_empty: bool,
               use_l1: bool, scale: float, row_coords=None):
    """K6, normal consistency of surface channel 0 at ``cells`` or, with
    ``cells`` None, at every cell whose 3x3x3 window lies in the lattice:
    the kernel then visits the present rows of ``row_coords`` (cap, 3), each
    the base vertex of its cell. Returns the loss (1,) and its gradient
    (cap, n_surf_c)."""
    _check("surface", surface, torch.float32)
    _check("level_sets", level_sets, torch.float32)
    cp = _cells_arg(links, cells)
    rp, n = _rows_arg(cells, row_coords, surface.shape[0])
    X, Y, Z = links.shape
    loss = torch.zeros(1, dtype=torch.float64, device=surface.device)
    grad = torch.zeros_like(surface)
    if n > 0:
        _launch("reg", "reg_normal", "reg_normal", _ptr(links), X, Y, Z, cp, rp, n, _ptr(surface),
                surface.shape[1], _ptr(level_sets), level_sets.numel(), int(con_check),
                int(ignore_empty), int(use_l1), float(scale), _ptr(loss), _ptr(grad))
        if cells is None:
            LAUNCHES["reg_normal_every"] += 1
    return loss.float(), grad


def reg_sparsify(links, cells, density, surface, scale_alpha: float, scale_surf: float,
                 surf_decrease: bool, surf_thresh: float, scale: float):
    """K6, the alpha/surface sparsifier at ``cells``. ``density`` (rows, 1)
    is read at row min(link, rows - 1), as fetch_links clips (UDF_ALPHA's
    table; such a launch also counts as ``reg_sparsify_table``). Returns the
    loss (1,) and the gradients of density (rows, 1) and surface (cap,
    n_surf_c)."""
    rows = density.shape[0]
    _check("density", density, torch.float32, (rows, 1))
    _check("surface", surface, torch.float32)
    cp = _cells_arg(links, cells)
    n = links.numel() if cells is None else cells.numel()
    loss = torch.zeros(1, dtype=torch.float64, device=density.device)
    g_density = torch.zeros_like(density)
    g_surface = torch.zeros_like(surface)
    X, Y, Z = links.shape
    if n > 0:
        _launch("reg", "reg_sparsify", "reg_sparsify", _ptr(links), X, Y, Z, cp, n, _ptr(density),
                rows, _ptr(surface), surface.shape[1], float(scale_alpha), float(scale_surf),
                1.0 if surf_decrease else -1.0, float(surf_thresh), float(scale), _ptr(loss),
                _ptr(g_density), _ptr(g_surface))
        if rows < surface.shape[0]:
            LAUNCHES["reg_sparsify_table"] += 1
    return loss.float(), g_density, g_surface


# ---------------------------------------------------------------------------
# K12a-K12d
# ---------------------------------------------------------------------------

_EXT_KINDS = {"reg_norm_match": 0, "reg_viscosity": 1, "reg_sign_change": 2, "reg_eikonal": 3,
              "reg_lumisphere": 4}


def _reg_ext(name: str, links, cells, surface, scale: float, density=None, h=None,
             eta: float = 0.0, target: float = 0.0):
    """One K12 launch over ``cells`` (flat ids, int32): the loss (1,),
    summed in float64 and returned as float32, the gradient of ``surface``
    (cap, n_surf_c) and, with ``density`` (cap, 1), its gradient."""
    cap = surface.shape[0]
    _check("surface", surface, torch.float32)
    _check("links", links, torch.int32)
    _check("cells", cells, torch.int32)
    if density is not None:
        _check("density", density, torch.float32, (density.shape[0], 1))
    if h is not None:
        _check("h", h, torch.float32, (1,))
    n = cells.numel()
    loss = torch.zeros(1, dtype=torch.float64, device=surface.device)
    g_surface = torch.zeros_like(surface)
    g_density = None if density is None else torch.zeros_like(density)
    X, Y, Z = links.shape
    if n > 0:
        _launch("reg", "reg_ext", name, _EXT_KINDS[name], _ptr(links), X, Y, Z, _ptr(cells), n,
                cap, _ptr(surface), surface.shape[1], 0 if density is None else _ptr(density),
                0 if density is None else density.shape[0], 0 if h is None else _ptr(h),
                float(eta), float(target), float(scale), _ptr(loss), _ptr(g_surface), 0 if g_density is None else _ptr(g_density), None, 0, None,
                0.0, None)
    return loss.float(), g_surface, g_density


def reg_norm_match(links, cells, density, surface, scale: float):
    """K12a, the unit forward differences of surface channel 0 against raw
    alpha's. Returns the loss (1,) and the gradients of density (cap, 1)
    and surface (cap, n_surf_c)."""
    loss, g_surface, g_density = _reg_ext("reg_norm_match", links, cells, surface, scale,
                                          density=density)
    return loss, g_density, g_surface


def reg_viscosity(links, cells, surface, h, eta: float, scale: float):
    """K12b, the viscosity eikonal term, with the grid spacing ``h`` a (1,)
    float32 tensor on the card. Returns the loss (1,) and the gradient of
    surface (cap, n_surf_c)."""
    return _reg_ext("reg_viscosity", links, cells, surface, scale, h=h, eta=eta)[:2]


def reg_sign_change(links, cells, surface, scale: float):
    """K12c, the sign-change term; a -1 link reads and trains row cap - 1.
    Returns the loss (1,) and the gradient of surface (cap, n_surf_c)."""
    return _reg_ext("reg_sign_change", links, cells, surface, scale)[:2]


def reg_eikonal(links, cells, surface, target: float, scale: float):
    """K12d, (|g| - target)^2 over the cells whose 8 corners are present.
    Returns the loss (1,) and the gradient of surface (cap, n_surf_c)."""
    return _reg_ext("reg_eikonal", links, cells, surface, scale, target=target)[:2]


def reg_lumisphere(links, cells, sh, mult, dir_factor: float, scale: float):
    """K12e, the lumisphere TV of the SH colours (cap, 3 bd) along the
    direction whose basis is mult[0] and its twin's mult[1] ((2, bd) on the
    card). Returns the loss (1,) and the gradient of sh."""
    cap, C = sh.shape
    bd = C // 3
    _check("sh", sh, torch.float32)
    _check("mult", mult, torch.float32, (2, bd))
    _check("links", links, torch.int32)
    _check("cells", cells, torch.int32)
    n = cells.numel()
    loss = torch.zeros(1, dtype=torch.float64, device=sh.device)
    g_sh = torch.zeros_like(sh)
    X, Y, Z = links.shape
    if n > 0:
        _launch("reg", "reg_ext", "reg_lumisphere", _EXT_KINDS["reg_lumisphere"], _ptr(links),
                X, Y, Z, _ptr(cells), n, cap, None, 0, None, 0, None, 0.0, 0.0, float(scale),
                _ptr(loss), None, None, _ptr(sh), bd, _ptr(mult), float(dir_factor),
                _ptr(g_sh))
    return loss.float(), g_sh


def reg_background_tv(links, cells, data, scaling: float, scaling_density: float,
                      scale: float):
    """K12f, the TV of the MSI background rows (n, nlayers, 4) at the flat
    (u, v, layer) ``cells`` (int32) of the (2R, R) ``links``. Returns the
    loss (1,) and the gradient of the rows."""
    _check("background_links", links, torch.int32)
    _check("background_data", data, torch.float32)
    _check("cells", cells, torch.int32)
    n = cells.numel()
    loss = torch.zeros(1, dtype=torch.float64, device=data.device)
    g_data = torch.zeros_like(data)
    W, H = links.shape
    if n > 0:
        _launch("reg", "reg_background_tv", "reg_background_tv", _ptr(links), W, H, _ptr(data),
                data.shape[1], _ptr(cells), n, float(scaling), float(scaling_density),
                float(scale), _ptr(loss), _ptr(g_data))
    return loss.float(), g_data


def reg_basis_tv(data, scale: float):
    """K12g, the TV of the learned 3D-texture basis (R, R, R, bd), every
    (R-1)^3 cell, times ``scale``. Returns the loss (1,) and its gradient
    (R, R, R, bd)."""
    _check("basis_data", data, torch.float32)
    R, bd = data.shape[0], data.shape[-1]
    if data.dim() != 4 or tuple(data.shape[:3]) != (R, R, R):
        raise ValueError(f"basis_data: expected (R, R, R, bd), got {tuple(data.shape)}")
    loss = torch.zeros(1, dtype=torch.float64, device=data.device)
    grad = torch.zeros_like(data)
    if R >= 2 and bd > 0:
        _launch("reg", "reg_basis_tv", "reg_basis_tv", _ptr(data), R, bd, float(scale),
                _ptr(loss), _ptr(grad))
    return loss.float(), grad


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def rmsprop(param, rms, grad, lr: float, beta: float, epsilon: float, minval, grad_abs_max,
            frozen: bool) -> None:
    """K7: one masked RMSprop step of ``param`` and ``rms`` (rows, C), in
    place."""
    rows = param.shape[0]
    shape = tuple(param.shape)
    _check("param", param, torch.float32)
    _check("rms", rms, torch.float32, shape)
    _check("grad", grad, torch.float32, shape)
    if rows == 0:
        return
    C = param[0].numel()
    _launch("rmsprop", "rmsprop", "rmsprop", _ptr(param), _ptr(rms), _ptr(grad), rows, C,
            float(lr), float(beta), float(1.0 - beta), float(epsilon),
            int(grad_abs_max is not None), float(grad_abs_max or 0.0), int(minval is not None),
            float(minval or 0.0), int(frozen))


# ---------------------------------------------------------------------------
# K1d
# ---------------------------------------------------------------------------

def density_occupancy(links, density):
    """K1d: (X-1, Y-1, ceil((Z-1)/32)) int32 occupancy words of the cuvol
    renderer (a present corner with density > 0)."""
    X, Y, Z = links.shape
    _check("links", links, torch.int32)
    _check("density", density, torch.float32, (density.shape[0],))
    words = torch.empty((X - 1, Y - 1, (Z - 1 + 31) // 32), dtype=torch.int32, device=links.device)
    if words.numel() == 0:
        return words
    _launch("occupancy", "density_occupancy_words", "density_occupancy", _ptr(links),
            _ptr(density), X, Y, Z, _ptr(words))
    return words


# ---------------------------------------------------------------------------
# K8 and K10
# ---------------------------------------------------------------------------

def _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links, density, sh):
    B = origins.shape[0]
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    bd = sh_mult.shape[1]
    _check("sh_mult", sh_mult, torch.float32, (B, bd))
    for name, x in (("delta_scale", delta_scale), ("tmin", tmin), ("tmax", tmax)):
        _check(name, x, torch.float32, (B,))
    _check("links", links, torch.int32)
    cap = density.shape[0]
    _check("density", density, torch.float32, (cap,))
    _check("sh", sh, torch.float32, (cap, 3 * bd))
    X, Y, Z = links.shape
    return B, bd, (_ptr(sh_mult), bd, _ptr(delta_scale), _ptr(tmin), _ptr(tmax), _ptr(links),
                   X, Y, Z, _ptr(density), _ptr(sh))


def _pool_entry_args(offsets, l, close_t, far_t, B: int):
    M = close_t.shape[0]
    _check("offsets", offsets, torch.int64, (B + 1,))
    _check("l", l, torch.int32, (M, 3))
    _check("close_t", close_t, torch.float32, (M,))
    _check("far_t", far_t, torch.float32, (M,))
    return M


def _render_outputs(B: int, dev, depth_sigma_thresh) -> dict:
    f32 = dict(dtype=torch.float32, device=dev)
    return {"rgb": torch.empty((B, 3), **f32), "depth": torch.empty(B, **f32),
            "log_T": torch.empty(B, **f32),
            "t_sig": None if depth_sigma_thresh is None else torch.empty(B, **f32)}


def cuvol_forward(offsets, l, close_t, far_t, origins, dirs, sh_mult, delta_scale, tmin, tmax,
                  links, density, sh, step: float, n_slots: int, last_sample_opaque: bool,
                  bg: float, depth_sigma_thresh=None, save_entry_pre: bool = False,
                  bg_rgb=None) -> dict:
    """K8 forward over the pool (ray r's entries at [offsets[r], offsets[r+1])):
    rgb (B, 3), depth, log_T and t_sig ((B,), or None without a
    ``depth_sigma_thresh``), and entry_pre (M,), the prefix log-attenuation
    at each entry's start, with ``save_entry_pre`` (else None). ``bg_rgb``
    (B, 3), K13's per-ray background colour, takes the place of ``bg``."""
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    M = _pool_entry_args(offsets, l, close_t, far_t, B)
    out = _render_outputs(B, origins.device, depth_sigma_thresh)
    out["entry_pre"] = (torch.empty(M, dtype=torch.float32, device=origins.device)
                        if save_entry_pre else None)
    bgp = _bg_rgb_ptr(bg_rgb, B)
    if B > 0:
        dst_on = depth_sigma_thresh is not None
        _launch("cuvol", "cuvol_forward", "cuvol_forward",
                _ptr(offsets), B, _ptr(l), _ptr(close_t), _ptr(far_t), _ptr(origins), _ptr(dirs),
                *grid_args, float(step), int(n_slots), int(last_sample_opaque), float(bg), bgp,
                int(dst_on), float(depth_sigma_thresh) if dst_on else 0.0,
                *(0 if out[k] is None else _ptr(out[k])
                  for k in ("rgb", "depth", "log_T", "t_sig", "entry_pre")))
    return out


def _out_cotangent_ptrs(g_depth, g_log_T, B: int) -> tuple:
    """The pointers of the depth and log_T (or acc) cotangents (B,), None
    for an absent one."""
    for name, g in (("g_depth", g_depth), ("g_log_T", g_log_T)):
        if g is not None:
            _check(name, g, torch.float32, (B,))
    return tuple(None if g is None else _ptr(g) for g in (g_depth, g_log_T))


def _grad_outputs(density, sh, B: int, bd: int, want_sh_mult: bool, kernel: str):
    g_shm = None
    if want_sh_mult:
        if bd > 32:
            raise ValueError(f"{kernel}: the basis gradient takes bd <= 32, got {bd}")
        g_shm = torch.zeros((B, bd), dtype=torch.float32, device=density.device)
    return torch.zeros_like(density), torch.zeros_like(sh), g_shm


def cuvol_backward(offsets, l, close_t, far_t, origins, dirs, sh_mult, delta_scale, tmin, tmax,
                   links, density, sh, step: float, n_slots: int, last_sample_opaque: bool,
                   bg: float, log_T, entry_pre, g_rgb, bg_rgb=None, want_sh_mult: bool = False,
                   g_depth=None, g_log_T=None):
    """K8 backward: the gradients of density (cap,) and SH (cap, 3 bd) from
    the cotangent of rgb (B, 3) and, when given, those of depth and log_T
    (B,) (the launch then also counts as ``cuvol_backward_out``), given the
    forward's log_T and entry_pre (and the forward's ``bg_rgb``). With
    ``want_sh_mult`` also the gradient of the per-ray basis sh_mult (B, bd),
    a third output (a launch with it also counts as
    ``cuvol_backward_basis``). bd is at most 32 in every instantiation."""
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    M = _pool_entry_args(offsets, l, close_t, far_t, B)
    _check("log_T", log_T, torch.float32, (B,))
    _check("entry_pre", entry_pre, torch.float32, (M,))
    _check("g_rgb", g_rgb, torch.float32, (B, 3))
    out_ptrs = _out_cotangent_ptrs(g_depth, g_log_T, B)
    if bd > 32:
        raise ValueError(f"cuvol_backward: a warp adds SH rows of 3 bd <= 96 elements, bd {bd}")
    g_density, g_sh, g_shm = _grad_outputs(density, sh, B, bd, want_sh_mult, "cuvol_backward")
    bgp = _bg_rgb_ptr(bg_rgb, B)
    if B > 0 and M > 0:
        _launch("cuvol", "cuvol_backward", "cuvol_backward",
                _ptr(offsets), B, _ptr(l), _ptr(close_t), _ptr(far_t), _ptr(origins), _ptr(dirs),
                *grid_args, float(step), int(n_slots), int(last_sample_opaque), float(bg), bgp,
                _ptr(log_T), _ptr(entry_pre), _ptr(g_rgb), *out_ptrs, _ptr(g_density), _ptr(g_sh),
                _ptr(g_shm) if want_sh_mult else None, density.shape[0])
        if want_sh_mult:
            LAUNCHES["cuvol_backward_basis"] += 1
        if out_ptrs != (None, None):
            LAUNCHES["cuvol_backward_out"] += 1
    return (g_density, g_sh, g_shm) if want_sh_mult else (g_density, g_sh)


# K10's checkpoint spacing: the forward keeps log_T before every
# MARCH_SEGMENT-th step (cuvol.cu's kSeg)
MARCH_SEGMENT = 64


def cuvol_march(origins, dirs, sh_mult, delta_scale, tmin, tmax, links, density, sh,
                step: float, n_steps: int, last_sample_opaque: bool, bg: float,
                depth_sigma_thresh=None, bg_rgb=None, checkpoints: bool = False) -> dict:
    """K10: the dense march of each ray, t = tmin + k step for k < n_steps
    while t <= tmax: rgb (B, 3), depth, log_T and t_sig (or None).
    ``bg_rgb`` (B, 3), K13's per-ray background colour, takes the place of
    ``bg``. With ``checkpoints`` also ckpt (B, ceil(n_steps /
    MARCH_SEGMENT)), each ray's log_T before every MARCH_SEGMENT-th step,
    which ``cuvol_march_backward`` takes (entries past a ray's last step
    are not written)."""
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    out = _render_outputs(B, origins.device, depth_sigma_thresh)
    n_seg = (int(n_steps) + MARCH_SEGMENT - 1) // MARCH_SEGMENT
    out["ckpt"] = (torch.empty((B, n_seg), dtype=torch.float32, device=origins.device)
                   if checkpoints else None)
    bgp = _bg_rgb_ptr(bg_rgb, B)
    if B > 0:
        dst_on = depth_sigma_thresh is not None
        _launch("cuvol", "cuvol_march", "cuvol_march", B, _ptr(origins), _ptr(dirs), *grid_args,
                float(step), int(n_steps), int(last_sample_opaque), float(bg), bgp, int(dst_on),
                float(depth_sigma_thresh) if dst_on else 0.0,
                *(None if out[k] is None else _ptr(out[k])
                  for k in ("rgb", "depth", "log_T", "t_sig", "ckpt")))
    return out


def cuvol_march_backward(origins, dirs, sh_mult, delta_scale, tmin, tmax, links, density, sh,
                         step: float, n_steps: int, last_sample_opaque: bool, bg: float, log_T,
                         ckpt, g_rgb, g_depth=None, g_log_T=None, bg_rgb=None,
                         want_sh_mult: bool = False):
    """K10 backward: the gradients of density (cap,) and SH (cap, 3 bd) from
    the cotangents of rgb (B, 3) and, when given, of depth and log_T (B,),
    given the forward's log_T and ckpt (``cuvol_march(...,
    checkpoints=True)``, same inputs and ``bg_rgb``). With ``want_sh_mult``
    also the gradient of the per-ray basis sh_mult (B, bd), a third output
    (bd at most 32)."""
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    n_seg = (int(n_steps) + MARCH_SEGMENT - 1) // MARCH_SEGMENT
    _check("log_T", log_T, torch.float32, (B,))
    _check("ckpt", ckpt, torch.float32, (B, n_seg))
    _check("g_rgb", g_rgb, torch.float32, (B, 3))
    out_ptrs = _out_cotangent_ptrs(g_depth, g_log_T, B)
    g_density, g_sh, g_shm = _grad_outputs(density, sh, B, bd, want_sh_mult,
                                           "cuvol_march_backward")
    bgp = _bg_rgb_ptr(bg_rgb, B)
    if B > 0:
        _launch("cuvol", "cuvol_march_backward", "cuvol_march_backward", B, _ptr(origins),
                _ptr(dirs), *grid_args, float(step), int(n_steps), int(last_sample_opaque),
                float(bg), bgp, _ptr(log_T), _ptr(ckpt), _ptr(g_rgb), *out_ptrs, _ptr(g_density),
                _ptr(g_sh), _ptr(g_shm) if want_sh_mult else None)
    return (g_density, g_sh, g_shm) if want_sh_mult else (g_density, g_sh)


# ---------------------------------------------------------------------------
# K9a and K9b: keep masks and lattice resample of the stage transitions
# ---------------------------------------------------------------------------

def _window_or(counter: str, crit, thresh: float, src, n_in: int, axis: int, a: int, b: int,
               dims) -> torch.Tensor:
    """One 1-D pass of K9a: out (dims, uint8) = OR of the input over
    [i + a, i + b] along ``axis`` (input dims = dims with n_in on axis); the
    input is ``crit >= thresh`` when ``crit`` is given, else ``src``."""
    dev = (crit if crit is not None else src).device
    out = torch.empty(tuple(dims), dtype=torch.uint8, device=dev)
    if out.numel() > 0:
        _launch("topology", "topo_window_or", counter, 0 if crit is None else _ptr(crit),
                float(thresh), 0 if src is None else _ptr(src), int(n_in), int(axis), int(a),
                int(b), *(int(d) for d in dims), _ptr(out))
    return out


def _dilate_passes(counter: str, crit, thresh: float, src, n: int) -> torch.Tensor:
    """Threshold (from ``crit``) or copy ``src``, then the (2n+1)^3 box
    maximum as three 1-D passes."""
    dims = tuple((crit if crit is not None else src).shape)
    if n <= 0:
        return _window_or(counter, crit, thresh, src, dims[0], 0, 0, 0, dims)
    m = _window_or(counter, crit, thresh, src, dims[0], 0, -n, n, dims)
    m = _window_or(counter, None, 0.0, m, dims[1], 1, -n, n, dims)
    return _window_or(counter, None, 0.0, m, dims[2], 2, -n, n, dims)


def keep_mask(crit, thresh: float, dilate: int) -> torch.Tensor:
    """K9a: (X, Y, Z) bool, ``crit >= thresh`` dilated by a (2 dilate + 1)^3
    Chebyshev window (zero outside the lattice)."""
    _check("crit", crit, torch.float32)
    if crit.dim() != 3:
        raise ValueError(f"crit: expected (X, Y, Z), got shape {tuple(crit.shape)}")
    return _dilate_passes("keep_mask", crit, thresh, None, int(dilate)).view(torch.bool)


def prune_mask(links, density, surface, thresh: float, dilate: int) -> torch.Tensor:
    """K9a, the prune rule: (X, Y, Z) bool, present density > thresh and,
    with ``surface`` (cap,), a sign change (or a zero) among the 27
    neighbours (zero outside the lattice and at empty links), dilated by a
    (2 dilate + 1)^3 window."""
    X, Y, Z = links.shape
    _check("links", links, torch.int32)
    cap = density.shape[0]
    _check("density", density, torch.float32, (cap,))
    if surface is not None:
        _check("surface", surface, torch.float32, (cap,))
    valid = torch.empty((X, Y, Z), dtype=torch.uint8, device=links.device)
    if valid.numel() == 0:
        return valid.view(torch.bool)
    _launch("topology", "topo_prune_valid", "prune_mask", _ptr(links), _ptr(density),
            0 if surface is None else _ptr(surface), float(thresh), X, Y, Z, _ptr(valid))
    if int(dilate) <= 0:
        return valid.view(torch.bool)
    return _dilate_passes("keep_mask", None, 0.0, valid, int(dilate)).view(torch.bool)


def lv_band(surface, level_sets) -> torch.Tensor:
    """K9a, the level-set band: (X, Y, Z) bool, the 8 corners of every voxel
    of the dense ``surface`` (X, Y, Z) whose corner range [min, max] holds a
    level set."""
    _check("surface", surface, torch.float32)
    _check("level_sets", level_sets, torch.float32)
    X, Y, Z = surface.shape
    vox = torch.empty((max(X - 1, 0), max(Y - 1, 0), max(Z - 1, 0)), dtype=torch.uint8,
                      device=surface.device)
    if vox.numel() > 0:
        _launch("topology", "topo_straddle", "lv_band", _ptr(surface), X, Y, Z, _ptr(level_sets),
                level_sets.numel(), _ptr(vox))
    m = _window_or("lv_band", None, 0.0, vox, X - 1, 0, -1, 0, (X, Y - 1, Z - 1))
    m = _window_or("lv_band", None, 0.0, m, Y - 1, 1, -1, 0, (X, Y, Z - 1))
    return _window_or("lv_band", None, 0.0, m, Z - 1, 2, -1, 0, (X, Y, Z)).view(torch.bool)


def _table_args(tables, new_reso) -> list:
    """Pointers of the per-axis (l int32, f, g float32) tables, x then y
    then z, after checking each against its new lattice size."""
    args = []
    for ax, (l, f, g) in enumerate(tables):
        n = int(new_reso[ax])
        _check(f"l[{ax}]", l, torch.int32, (n,))
        _check(f"f[{ax}]", f, torch.float32, (n,))
        _check(f"g[{ax}]", g, torch.float32, (n,))
        args += [_ptr(l), _ptr(f), _ptr(g)]
    return args


def resample_dense(links, col, fill: float, tables, new_reso) -> torch.Tensor:
    """K9b, every new vertex of one channel: (Xn, Yn, Zn) float32, the
    separable trilerp of ``col`` (cap,) through ``links`` with ``fill`` at
    empty corners, at the cells and weights of ``tables``."""
    _check("links", links, torch.int32)
    _check("col", col, torch.float32, (col.shape[0],))
    targs = _table_args(tables, new_reso)
    Xn, Yn, Zn = (int(r) for r in new_reso)
    out = torch.empty((Xn, Yn, Zn), dtype=torch.float32, device=links.device)
    if out.numel() > 0:
        _, Y, Z = links.shape
        _launch("topology", "topo_resample_dense", "resample_dense", _ptr(links), Y, Z, _ptr(col),
                float(fill), *targs, Xn, Yn, Zn, _ptr(out))
    return out


def resample_rows(links, rows, fills, kept, tables, new_reso, want_touched: bool):
    """K9b, all channels of the kept new vertices: (N, C) float32 rows at
    the flat new-lattice ids ``kept`` (N,) int64, channel c filled with
    ``fills[c]`` at empty corners; and (N,) bool, whether a corner of the
    old cell was empty (with ``want_touched``, else None)."""
    _check("links", links, torch.int32)
    cap, C = rows.shape
    _check("rows", rows, torch.float32)
    _check("fills", fills, torch.float32, (C,))
    N = kept.shape[0]
    _check("kept", kept, torch.int64, (N,))
    targs = _table_args(tables, new_reso)
    out = torch.empty((N, C), dtype=torch.float32, device=links.device)
    touched = torch.empty(N, dtype=torch.uint8, device=links.device) if want_touched else None
    if N > 0:
        _, Y, Z = links.shape
        _launch("topology", "topo_resample_rows", "resample_rows", _ptr(links), Y, Z, _ptr(rows),
                C, _ptr(fills), _ptr(kept), N, *targs, int(new_reso[1]), int(new_reso[2]),
                _ptr(out), 0 if touched is None else _ptr(touched))
    return out, None if touched is None else touched.view(torch.bool)


# ---------------------------------------------------------------------------
# K9c, K9d, K9e and K9f: the camera sweeps of the stage transitions
# ---------------------------------------------------------------------------

def _sweep_rays(origins, dirs, t0, t1) -> int:
    B = origins.shape[0]
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    _check("t0", t0, torch.float32, (B,))
    _check("t1", t1, torch.float32, (B,))
    return B


def weight_march(origins, dirs, world_step, tmin, tmax, vol, step: float, stop_thresh: float,
                 n_steps: int, wt_bits) -> None:
    """K9c: march each ray through the dense ``vol`` (X, Y, Z) float32 and
    raise ``wt_bits`` (X*Y*Z,) int32, the bits of non-negative float32
    weights, to the largest weight of any sample in a voxel, at its 8
    corners; in place."""
    B = _sweep_rays(origins, dirs, tmin, tmax)
    _check("world_step", world_step, torch.float32, (B,))
    _check("vol", vol, torch.float32)
    _check("wt_bits", wt_bits, torch.int32, (vol.numel(),))
    if B > 0:
        X, Y, Z = vol.shape
        _launch("sweep", "weight_march", "weight_march", _ptr(origins), _ptr(dirs),
                _ptr(world_step), _ptr(tmin), _ptr(tmax), B, _ptr(vol), X, Y, Z, float(step),
                float(stop_thresh), int(n_steps), _ptr(wt_bits))


def visibility(origins, dirs, tnear, tmax, links, surface, level_sets, counts) -> None:
    """K9d: add 1 to ``counts`` (cap,) int32 at each present corner of every
    voxel each ray walks before, and including, the first voxel with a
    surface hit; in place."""
    B = _sweep_rays(origins, dirs, tnear, tmax)
    _check("links", links, torch.int32)
    cap = surface.shape[0]
    _check("surface", surface, torch.float32, (cap,))
    _check("level_sets", level_sets, torch.float32)
    _check("counts", counts, torch.int32, (cap,))
    if B > 0:
        X, Y, Z = links.shape
        _launch("sweep", "visibility", "visibility", _ptr(origins), _ptr(dirs), _ptr(tnear),
                _ptr(tmax), B, _ptr(links), X, Y, Z, _ptr(surface), _ptr(level_sets),
                level_sets.numel(), _ptr(counts))


def transmit_march(origins, dirs, world_step, tmin, tmax, links, density, step: float,
                   stop_thresh: float, n_steps: int, out_bits) -> None:
    """K9e: march each ray through the sparse grid (``links`` (X, Y, Z),
    raw ``density`` (cap,) float32) and raise ``out_bits`` (cap,) int32,
    the bits of non-negative float32 transmittances, to the largest
    transmittance before any hit sample at each present corner; in place."""
    B = _sweep_rays(origins, dirs, tmin, tmax)
    _check("world_step", world_step, torch.float32, (B,))
    _check("links", links, torch.int32)
    cap = density.shape[0]
    _check("density", density, torch.float32, (cap,))
    _check("out_bits", out_bits, torch.int32, (cap,))
    if B > 0:
        X, Y, Z = links.shape
        _launch("sweep", "transmit_march", "transmit_march", _ptr(origins), _ptr(dirs),
                _ptr(world_step), _ptr(tmin), _ptr(tmax), B, _ptr(links), _ptr(density), X, Y, Z,
                float(step), float(stop_thresh), int(n_steps), _ptr(out_bits))


def mask_march(origins, dirs, tnear, tmax, links, out) -> None:
    """K9f: set ``out`` (cap,) float32 to 1 at each present corner of every
    voxel each ray crosses in [tnear, tmax]; in place."""
    B = _sweep_rays(origins, dirs, tnear, tmax)
    _check("links", links, torch.int32)
    _check("out", out, torch.float32)
    if B > 0:
        X, Y, Z = links.shape
        _launch("sweep", "mask_march", "mask_march", _ptr(origins), _ptr(dirs), _ptr(tnear),
                _ptr(tmax), B, _ptr(links), X, Y, Z, _ptr(out))


# ---------------------------------------------------------------------------
# K9g: iso points of the extraction
# ---------------------------------------------------------------------------

def iso_points(cells, links, field, density, lv: float, density_thresh: float, n_sample: int):
    """K9g: (N, 3 n^2, 3) float32 grid-space points of the cells (flat
    link-lattice ids (N,) int64) on rays along each axis, NaN where a ray
    has none; ``field`` (cap,) is the surface (or the density) and ``lv``
    its level."""
    N = cells.shape[0]
    _check("cells", cells, torch.int64, (N,))
    _check("links", links, torch.int32)
    cap = density.shape[0]
    _check("field", field, torch.float32, (cap,))
    _check("density", density, torch.float32, (cap,))
    n = int(n_sample)
    out = torch.empty((N, 3 * n * n, 3), dtype=torch.float32, device=cells.device)
    if out.numel() > 0:
        X, Y, Z = links.shape
        _launch("extract", "iso_points", "iso_points", _ptr(cells), N, _ptr(links), X, Y, Z,
                _ptr(field), _ptr(density), float(lv), float(density_thresh), n, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def _background_args(origins, dirs, delta_scale, reso, links, data) -> tuple:
    B = origins.shape[0]
    _check("origins", origins, torch.float32, (B, 3))
    _check("dirs", dirs, torch.float32, (B, 3))
    _check("delta_scale", delta_scale, torch.float32, (B,))
    _check("background_links", links, torch.int32)
    R = links.shape[1]
    _check("background_links", links, torch.int32, (2 * R, R))
    _check("background_data", data, torch.float32)
    if data.dim() != 3 or data.shape[2] != 4:
        raise ValueError(f"background_data: expected (n, nlayers, 4), got {tuple(data.shape)}")
    return B, (_ptr(origins), _ptr(dirs), _ptr(delta_scale), B, *(float(r) for r in reso),
               _ptr(links), R, _ptr(data), data.shape[0], data.shape[1])


def background_forward(origins, dirs, delta_scale, reso, links, n_steps: int,
                       brightness: float, data):
    """K13 forward: each ray's background colour c_bg (B, 3), the brightness
    term included, and log_T_bg (B,), rendered from log_T = 0 over
    ``n_steps`` spheres; rays in grid coordinates (unit dirs) of a grid of
    ``reso``, with their grid->world step scale."""
    B, args = _background_args(origins, dirs, delta_scale, reso, links, data)
    c_bg = torch.empty((B, 3), dtype=torch.float32, device=origins.device)
    log_T = torch.empty(B, dtype=torch.float32, device=origins.device)
    if B > 0:
        _launch("background", "background_forward", "background_forward", *args, int(n_steps),
                float(brightness), _ptr(c_bg), _ptr(log_T))
    return c_bg, log_T


def background_backward(origins, dirs, delta_scale, reso, links, n_steps: int,
                        brightness: float, data, log_T, g_c, g_lt):
    """K13 backward: the gradient of background_data (n, nlayers, 4) from the
    cotangents of c_bg (B, 3) and log_T_bg (B,), given the forward's
    log_T_bg."""
    B, args = _background_args(origins, dirs, delta_scale, reso, links, data)
    _check("log_T", log_T, torch.float32, (B,))
    _check("g_c", g_c, torch.float32, (B, 3))
    _check("g_lt", g_lt, torch.float32, (B,))
    g_data = torch.zeros_like(data)
    if B > 0:
        _launch("background", "background_backward", "background_backward", *args, int(n_steps),
                float(brightness), _ptr(log_T), _ptr(g_c), _ptr(g_lt), _ptr(g_data))
    return g_data


# ---------------------------------------------------------------------------
# K14: the compat marches
# ---------------------------------------------------------------------------

COMPAT_MODES = ("nvol", "svox1")


def _compat_mode(mode: str) -> int:
    if mode not in COMPAT_MODES:
        raise ValueError(f"compat mode {mode!r}; one of {COMPAT_MODES}")
    return COMPAT_MODES.index(mode)


def compat_forward(mode: str, origins, dirs, sh_mult, delta_scale, tmin, tmax, links, density,
                   sh, step: float, n_steps: int, sigma_thresh: float, bg: float) -> dict:
    """K14 forward, ``mode`` "nvol" or "svox1": rgb (B, 3), depth (B,) and
    acc (B,), the total alpha (nvol) or the log transmittance (svox1), of
    each ray's march t = tmin + k step, k < n_steps, while t <= tmax."""
    m = _compat_mode(mode)
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    f32 = dict(dtype=torch.float32, device=origins.device)
    out = {"rgb": torch.empty((B, 3), **f32), "depth": torch.empty(B, **f32),
           "acc": torch.empty(B, **f32)}
    if B > 0:
        _launch("compat", "compat_forward", f"compat_forward_{mode}", m, B, _ptr(origins),
                _ptr(dirs), *grid_args, float(step), int(n_steps), float(sigma_thresh), float(bg),
                _ptr(out["rgb"]), _ptr(out["depth"]), _ptr(out["acc"]))
    return out


def compat_backward(mode: str, origins, dirs, sh_mult, delta_scale, tmin, tmax, links, density,
                    sh, step: float, n_steps: int, sigma_thresh: float, bg: float, g_rgb,
                    want_sh_mult: bool = False, g_depth=None, g_acc=None):
    """K14 backward: the gradients of density (cap,) and SH (cap, 3 bd) from
    the cotangent of rgb (B, 3), and with ``want_sh_mult`` that of the
    per-ray basis (B, bd), a third output (bd at most 32; svox1 at most
    8192 steps). ``g_depth`` and ``g_acc`` (B,), the cotangents of depth and
    of acc (nvol's total alpha, svox1's log T), launch the second
    instantiation (also counted as ``compat_backward_out_<mode>``)."""
    m = _compat_mode(mode)
    B, bd, grid_args = _cuvol_args(origins, dirs, sh_mult, delta_scale, tmin, tmax, links,
                                   density, sh)
    _check("g_rgb", g_rgb, torch.float32, (B, 3))
    out_ptrs = _out_cotangent_ptrs(g_depth, g_acc, B)
    if want_sh_mult and bd > 32:
        raise ValueError(f"compat_backward: the basis gradient takes bd <= 32, got {bd}")
    if mode == "svox1" and n_steps > 8192:
        raise ValueError(f"compat_backward: svox1 marches at most 8192 steps, got {n_steps}")
    g_density = torch.zeros_like(density)
    g_sh = torch.zeros_like(sh)
    g_shm = (torch.zeros((B, bd), dtype=torch.float32, device=origins.device) if want_sh_mult
             else None)
    if B > 0:
        _launch("compat", "compat_backward", f"compat_backward_{mode}", m, B, _ptr(origins),
                _ptr(dirs), *grid_args, float(step), int(n_steps), float(sigma_thresh), float(bg),
                _ptr(g_rgb), _ptr(g_density), _ptr(g_sh), _ptr(g_shm) if want_sh_mult else None,
                *out_ptrs)
        if out_ptrs != (None, None):
            LAUNCHES[f"compat_backward_out_{mode}"] += 1
    return (g_density, g_sh, g_shm) if want_sh_mult else (g_density, g_sh)

