"""K2: fused correspondence -- exact masked 1-nearest-neighbour search plus a
gather of the winner's feature row.

Counterpart of ``rivslam_tpu/ops/pallas_nn.py``'s
``fused_correspondence_pallas`` (the ``_corr_kernel`` TPU kernel), batched
over B problems:

    fused_correspondence(query [B,N,3], ref [B,M,3], ref_mask [B,M] bool,
                         feats [B,M,F])
        -> (idx [B,N] int32, d2 [B,N], g [B,N,F])

idx and d2 are K3's (``ops/nn_argmin``): the first index reaching the masked
minimum of |q|^2 + |r|^2 - 2 q.r, unclamped; idx 0 and d2 1e30 where a
problem has no valid ref. g is ``feats[idx]`` exactly, and zeros where there
is no valid ref. F is at most 128, as for the TPU kernel.

- ``fused_correspondence`` launches the hand-written CUDA kernel
  (``csrc/nn_corr.cu``: K3's compacted, split scan, then the gather; the
  split from ``nn_argmin.split_for``) for CUDA tensors and the plain twin
  for CPU tensors. It never falls back from one to the other.
- ``fused_correspondence_plain`` is that twin: K3's plain twin (the TPU
  kernel's 512-ref tiles, the kernel's distance arithmetic) and one gather
  at the end, so the two agree bitwise on idx, d2 and g.
- ``build`` compiles the kernel on first use (``ops/cuda_build.py``).

Two divergences from the TPU kernel, both recorded in ROADMAP.md: it gathers
with a one-hot matmul per tile, so a non-finite feature anywhere in a tile
would spoil every row whose winner lies there (here only the winner's row
is read); and callers that follow ``ops/knn`` (which clamps d2 at 0 before
its argmin) clamp K2's d2 themselves.
"""

from __future__ import annotations

import ctypes
import os

import torch

from rivslam_tpu_torch.ops import cuda_build, nn_argmin

BIG = nn_argmin.BIG
MAX_FEATURES = 128  # the TPU kernel's feature lanes (one f32 tile width)

SOURCE = os.path.join(cuda_build.CSRC, "nn_corr.cu")

_build: cuda_build.Build | None = None


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.rivslam_nn_corr_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def build() -> cuda_build.Build:
    """Compile (once per source hash) and load the kernel library."""
    global _build
    if _build is None:
        _build = cuda_build.build(SOURCE, _declare)
    return _build


def _check(query, ref, ref_mask, feats) -> tuple[int, int, int, int]:
    B, N, M = nn_argmin._check(query, ref, ref_mask)
    if feats.ndim != 3 or tuple(feats.shape[:2]) != (B, M):
        raise ValueError(f"feats must be [B={B}, M={M}, F], got {tuple(feats.shape)}")
    F = feats.shape[2]
    if not 1 <= F <= MAX_FEATURES:
        raise ValueError(f"feats must have 1..{MAX_FEATURES} features, got {F}")
    if feats.device != query.device:
        raise ValueError(f"feats on {feats.device}, query on {query.device}")
    return B, N, M, F


def fused_correspondence(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors, its plain twin on CPU tensors. See the module doc."""
    B, N, _, _ = _check(query, ref, ref_mask, feats)
    if query.device.type == "cpu":
        return fused_correspondence_plain(query, ref, ref_mask, feats)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    return _launch(query, ref, ref_mask, feats, nn_argmin.split_for(B, N, query.device))


def _launch(query, ref, ref_mask, feats, splits: int):
    """Launch K2 on checked CUDA tensors with the refs in ``splits`` slices
    (``fused_correspondence`` picks them; the card's tests and timings name
    them)."""
    B, N, _ = query.shape
    M, F = feats.shape[1:]
    cuda_build.check_launch(
        B, {"query": query, "ref": ref, "feats": feats}, {"ref_mask": ref_mask}
    )
    # idx, d2 and g in one allocation
    out = torch.empty(B * N * (2 + F), dtype=torch.int32, device=query.device)
    idx = out[:B * N].view(B, N)
    d2 = out[B * N:2 * B * N].view(torch.float32).view(B, N)
    g = out[2 * B * N:].view(torch.float32).view(B, N, F)
    cuda_build.launch(
        build().lib.rivslam_nn_corr_f32, query.device, query.data_ptr(), ref.data_ptr(),
        ref_mask.data_ptr(), feats.data_ptr(), idx.data_ptr(), d2.data_ptr(), g.data_ptr(),
        B, N, M, F, splits,
    )
    cuda_build.count_launch(fused_correspondence)
    return idx, d2, g


fused_correspondence.launches = 0  # K2 launches (CUDA path only), but for the loop worker's
fused_correspondence.worker_launches = 0  # those of the loop worker's thread


def fused_correspondence_plain(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K2, on any device and dtype: K3's tile-by-tile
    scan, then the winner's row (zeros where the running minimum was never
    replaced, i.e. no valid ref)."""
    _check(query, ref, ref_mask, feats)
    idx, d2 = nn_argmin.nearest_neighbor_plain(query, ref, ref_mask)
    rows = torch.take_along_dim(feats, idx.long()[..., None], dim=1)
    g = torch.where((d2 < BIG)[..., None], rows, 0.0).to(feats.dtype)
    return idx, d2, g
