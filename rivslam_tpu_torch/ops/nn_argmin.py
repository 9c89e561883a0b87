"""K3: exact masked 1-nearest-neighbour search (first-index argmin + d2).

Counterpart of ``rivslam_tpu/ops/pallas_nn.py``'s ``nearest_neighbor_pallas``
(the ``_nn_kernel`` TPU kernel), batched over B problems:

    nearest_neighbor(query [B,N,3], ref [B,M,3], ref_mask [B,M] bool)
        -> (idx [B,N] int32, d2 [B,N])

d2 is the masked minimum of |q|^2 + |r|^2 - 2 q.r, unclamped, and idx the
first index reaching it; where a problem has no valid ref, d2 is 1e30 and
idx 0. This is the TPU kernel's contract, not quite ``ops/knn``'s (which
clamps at 0 and gives +inf): callers restore that themselves.

- ``nearest_neighbor`` launches the hand-written CUDA kernel
  (``csrc/nn_argmin.cu``, its scan in ``csrc/nn_scan.cuh``) for CUDA tensors
  and the plain twin for CPU tensors. It never falls back from one to the
  other. The kernel scans only the valid refs and, where the grid of query
  blocks would leave SMs idle, splits them into ``split_for(B, N)`` slices
  scanned by the blocks of a thread-block cluster (8 at the engine's B=1,
  N=1024; 1 at B=256); every split gives the same bits.
- ``nearest_neighbor_plain`` is that twin: plain torch, the kernel's
  distance arithmetic (each product and sum rounded on its own) and the TPU
  kernel's tiles of 512 refs, so the two agree bitwise on d2 and idx.
- ``build`` compiles the kernel on first use (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import os

import torch

from rivslam_tpu_torch.ops import cuda_build

BIG = 1e30
TILE_M = 512  # the TPU kernel's ref tile (pallas_nn.TILE_M)
THREADS = 64  # queries per block (csrc/nn_scan.cuh kThreads), K2's too
MAX_SPLIT = 8  # ref slices of a query block: a cluster's portable maximum

SOURCE = os.path.join(cuda_build.CSRC, "nn_argmin.cu")

_build: cuda_build.Build | None = None


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.rivslam_nn_argmin_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.rivslam_nn_empty
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def split_for(B: int, N: int, device: torch.device) -> int:
    """The ref slices S that K2 and K3 launch for B problems of N queries: 1
    while the grid of query blocks (B x N / 64) gives every SM of the card a
    block, else as many as keep the grid within the card's SMs, at most
    MAX_SPLIT (the engine's B=1, N=1024 on 132 SMs: 16 blocks, S = 8)."""
    blocks = B * -(-N // THREADS)
    sms = cuda_build.sm_count(device)
    return 1 if blocks >= sms else max(1, min(MAX_SPLIT, sms // blocks))


def build() -> cuda_build.Build:
    """Compile (once per source hash) and load the kernel library."""
    global _build
    if _build is None:
        _build = cuda_build.build(SOURCE, _declare)
    return _build


def _check(query, ref, ref_mask) -> tuple[int, int, int]:
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
    devices = {t.device for t in (query, ref, ref_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return B, N, M


def nearest_neighbor(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors, its plain twin on CPU tensors. See the module doc."""
    B, N, _ = _check(query, ref, ref_mask)
    if query.device.type == "cpu":
        return nearest_neighbor_plain(query, ref, ref_mask)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    return _launch(query, ref, ref_mask, split_for(B, N, query.device))


def _launch(query, ref, ref_mask, splits: int):
    """Launch K3 on checked CUDA tensors with the refs in ``splits`` slices
    (``nearest_neighbor`` picks them; the card's tests and timings name
    them)."""
    B, N, _ = query.shape
    M = ref.shape[1]
    cuda_build.check_launch(B, {"query": query, "ref": ref}, {"ref_mask": ref_mask})
    out = torch.empty((2, B, N), dtype=torch.int32, device=query.device)
    idx, d2 = out[0], out[1].view(torch.float32)
    cuda_build.launch(
        build().lib.rivslam_nn_argmin_f32, query.device, query.data_ptr(), ref.data_ptr(),
        ref_mask.data_ptr(), idx.data_ptr(), d2.data_ptr(), B, N, M, splits,
    )
    cuda_build.count_launch(nearest_neighbor)
    return idx, d2


nearest_neighbor.launches = 0  # K3 launches (CUDA path only), but for the loop worker's
nearest_neighbor.worker_launches = 0  # those of the loop worker's thread


def nearest_neighbor_plain(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K3, on any device and dtype.

    Follows ``_nn_kernel`` tile by tile (512 refs): per tile the first-index
    argmin, kept only where the tile's minimum is strictly below the running
    one. A masked ref's distance is exactly 1e30 and never replaces it.
    """
    _check(query, ref, ref_mask)
    B, N, _ = query.shape
    qx, qy, qz = (query[..., k, None] for k in range(3))  # [B, N, 1]
    qn = qx * qx + qy * qy + qz * qz
    best = torch.full((B, N), BIG, dtype=query.dtype, device=query.device)
    idx = torch.zeros((B, N), dtype=torch.int32, device=query.device)
    for s in range(0, ref.shape[1], TILE_M):
        r = ref[:, s:s + TILE_M]
        m = ref_mask[:, None, s:s + TILE_M]  # [B, 1, TM]
        rx, ry, rz = (r[:, None, :, k] for k in range(3))  # [B, 1, TM]
        rn = rx * rx + ry * ry + rz * rz
        cross = qx * rx + qy * ry + qz * rz
        d2 = torch.where(m, (qn + rn) - 2.0 * cross, BIG)  # [B, N, TM]
        loc = torch.argmin(d2, dim=-1)
        tmin = torch.take_along_dim(d2, loc[..., None], dim=-1)[..., 0]
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        idx = torch.where(upd, (loc + s).to(torch.int32), idx)
    return idx, best
