"""K1: fused masked nearest-neighbour distance + tie-averaged feature gather.

Counterpart of ``rivslam_tpu/ops/pallas_nn.py``'s ``fused_gather_pallas``
(the ``_gather_kernel`` TPU kernel), batched over B registration problems:

    fused_gather(query [B,N,3], ref [B,M,3], ref_mask [B,M] bool,
                 feats_t [B,F,M]) -> (d2 [B,N], gathered [B,F,N])

d2 is the exact masked minimum of |q|^2 + |r|^2 - 2 q.r (1e30 where a
problem has no valid target); ``gathered`` holds the features of the nearest
target, averaged over exact ties, zeros where there is none.

- ``fused_gather`` launches the hand-written CUDA kernel
  (``csrc/nn_gather.cu``) for CUDA tensors and the plain twin for CPU
  tensors. It never falls back from one to the other.
- ``fused_gather_plain`` is that twin: plain torch with K1's semantics, the
  same distance arithmetic and tiles of 1024 targets.
- ``build`` compiles the kernel with ``nvcc`` into a shared library with a C
  interface, on first use, into ``rivslam_tpu_torch/_build/`` (keyed by a
  hash of the source and flags), and loads it with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

import torch

BIG = 1e30
TILE_M = 1024  # the TPU kernel's target tile (pallas_nn.TILE_M_GATHER)
MAX_BLOCKS_Y = 65535  # the launch puts problems on grid.y

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "nn_gather.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Build:
    """A built and loaded kernel library."""

    path: str
    seconds: float  # wall time of the nvcc call, 0.0 when already built
    ptxas: tuple[str, ...]  # nvcc's -Xptxas -v report (registers, smem, spills)
    lib: ctypes.CDLL


_build: Build | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH")
    return found


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"nn_gather_{h.hexdigest()[:16]}.so")


def build() -> Build:
    """Compile (once per source hash) and load the kernel library.

    nvcc writes to a temporary name that is renamed into place, so a
    concurrent or interrupted build never leaves a partial library behind
    and no lock is needed.
    """
    global _build
    if _build is not None:
        return _build
    path = library_path()
    seconds, ptxas = 0.0, ()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
        ptxas = tuple(
            ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in ln or "spill" in ln
        )
    lib = ctypes.CDLL(path)
    fn = lib.rivslam_nn_gather_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build = Build(path=path, seconds=seconds, ptxas=ptxas, lib=lib)
    return _build


def _check(query, ref, ref_mask, feats_t) -> tuple[int, int, int, int]:
    if query.ndim != 3 or query.shape[-1] != 3:
        raise ValueError(f"query must be [B, N, 3], got {tuple(query.shape)}")
    B, N, _ = query.shape
    if ref.ndim != 3 or ref.shape[0] != B or ref.shape[-1] != 3:
        raise ValueError(f"ref must be [B={B}, M, 3], got {tuple(ref.shape)}")
    M = ref.shape[1]
    if tuple(ref_mask.shape) != (B, M) or ref_mask.dtype != torch.bool:
        raise ValueError(
            f"ref_mask must be bool [B={B}, M={M}], got {ref_mask.dtype} "
            f"{tuple(ref_mask.shape)}"
        )
    if feats_t.ndim != 3 or feats_t.shape[0] != B or feats_t.shape[2] != M:
        raise ValueError(f"feats_t must be [B={B}, F, M={M}], got {tuple(feats_t.shape)}")
    devices = {t.device for t in (query, ref, ref_mask, feats_t)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return B, N, M, feats_t.shape[1]


def fused_gather(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    feats_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain twin on CPU tensors. See the module doc."""
    B, N, M, F = _check(query, ref, ref_mask, feats_t)
    if query.device.type == "cpu":
        return fused_gather_plain(query, ref, ref_mask, feats_t)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    for name, t in (("query", query), ("ref", ref), ("feats_t", feats_t)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if not ref_mask.is_contiguous():
        raise ValueError("ref_mask must be contiguous for the CUDA kernel")
    if B > MAX_BLOCKS_Y:
        raise ValueError(f"B={B} exceeds the kernel's {MAX_BLOCKS_Y} problems")
    d2 = torch.empty((B, N), dtype=torch.float32, device=query.device)
    g = torch.empty((B, F, N), dtype=torch.float32, device=query.device)
    fn = build().lib.rivslam_nn_gather_f32
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(),
            feats_t.data_ptr(), d2.data_ptr(), g.data_ptr(), B, N, M, F, stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_gather kernel launch failed: cudaError_t {err}")
    fused_gather.launches += 1
    return d2, g


fused_gather.launches = 0  # K1 launches (CUDA path only)


def fused_gather_plain(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    feats_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K1, on any device.

    Follows ``_gather_kernel`` tile by tile (1024 targets): per tile the
    minimum, the features of every target equal to it summed by an equality
    matmul, and ties across tiles summed and counted; the sum is divided by
    max(count, 1) at the end. The distance uses the CUDA kernel's exact
    operation order (each product and sum rounded on its own), so the two
    agree bitwise on d2 and on which targets win.
    """
    _check(query, ref, ref_mask, feats_t)
    B, N, _ = query.shape
    F = feats_t.shape[1]
    dt = query.dtype
    qx, qy, qz = (query[..., k, None] for k in range(3))  # [B, N, 1]
    qn = qx * qx + qy * qy + qz * qz
    best = torch.full((B, N), BIG, dtype=dt, device=query.device)
    g = torch.zeros((B, F, N), dtype=dt, device=query.device)
    cnt = torch.zeros((B, N), dtype=dt, device=query.device)
    for s in range(0, ref.shape[1], TILE_M):
        r = ref[:, s:s + TILE_M]
        m = ref_mask[:, None, s:s + TILE_M]  # [B, 1, TM]
        rx, ry, rz = (r[:, None, :, k] for k in range(3))  # [B, 1, TM]
        rn = rx * rx + ry * ry + rz * rz
        cross = qx * rx + qy * ry + qz * rz
        d2 = torch.where(m, (qn + rn) - 2.0 * cross, BIG)  # [B, N, TM]
        tmin = d2.amin(dim=-1)
        valid = tmin < 0.5 * BIG
        eq = ((d2 <= tmin[..., None]) & m & valid[..., None]).to(dt)
        gt = torch.bmm(feats_t[:, :, s:s + TILE_M].to(dt), eq.transpose(1, 2))
        ct = eq.sum(dim=-1)
        lt = tmin < best
        tie = (tmin == best) & valid
        g = torch.where(lt[:, None], gt, g + torch.where(tie[:, None], gt, 0.0))
        cnt = torch.where(lt, ct, cnt + torch.where(tie, ct, 0.0))
        best = torch.minimum(best, tmin)
    return best, g / torch.clamp_min(cnt, 1.0)[:, None]
