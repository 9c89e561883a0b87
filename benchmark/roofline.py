"""The work the port's nearest-neighbour kernels need, counted from their
inputs' shapes and masks, and the least time one H100 could take for it.

Whatever implements a kernel, its share of the roofline reads the same work:
the operations are the valid (query, reference) pairs of a launch times the 8
float32 operations of a squared distance (3 subtractions, 3 multiplies, 2
adds), and the bytes are each input read once and each output written once.
A query counts as valid where the caller's source mask holds it, since the
algorithm needs no distance for a padded query. The least time is the larger
of the operations over the float32 peak and the bytes over the memory
bandwidth (NVIDIA's H100 SXM data sheet: 67 TFLOP/s outside the tensor
cores, 3.35 TB/s; at the 700 W limit).

- K1 (``nn_gather``): query [B,N,3], ref [B,M,3] float32, ref mask [B,M]
  bool, features [B,F,M] float32 -> d2 [B,N], gathered [B,F,N] float32.
- K2 (``nn_corr``): query, ref, ref mask, features [B,M,F] -> index [B,N]
  int32, d2 [B,N], the winner's row [B,N,F] float32.
- K3 (``nn_argmin``): query, ref, ref mask -> index [B,N] int32, d2 [B,N].
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
OPS_PER_PAIR = 8
F32, I32, BOOL = 4, 4, 1


def valid_pairs(query_valid, ref_valid) -> int:
    """Sum over the problems of (valid queries) x (valid references)."""
    q = np.asarray(query_valid, np.int64)
    r = np.asarray(ref_valid, np.int64)
    return int(np.sum(q * r))


def k1_work(B: int, N: int, M: int, F: int, query_valid, ref_valid) -> tuple[int, int]:
    """(operations, bytes) of one K1 launch."""
    ops = OPS_PER_PAIR * valid_pairs(query_valid, ref_valid)
    read = F32 * B * N * 3 + F32 * B * M * 3 + BOOL * B * M + F32 * B * F * M
    written = F32 * B * N + F32 * B * F * N
    return ops, read + written


def k2_work(B: int, N: int, M: int, F: int, query_valid, ref_valid) -> tuple[int, int]:
    """(operations, bytes) of one K2 launch."""
    ops = OPS_PER_PAIR * valid_pairs(query_valid, ref_valid)
    read = F32 * B * N * 3 + F32 * B * M * 3 + BOOL * B * M + F32 * B * M * F
    written = I32 * B * N + F32 * B * N + F32 * B * N * F
    return ops, read + written


def k3_work(B: int, N: int, M: int, query_valid, ref_valid) -> tuple[int, int]:
    """(operations, bytes) of one K3 launch."""
    ops = OPS_PER_PAIR * valid_pairs(query_valid, ref_valid)
    read = F32 * B * N * 3 + F32 * B * M * 3 + BOOL * B * M
    written = I32 * B * N + F32 * B * N
    return ops, read + written


def least_time_s(ops: int, nbytes: int) -> tuple[float, str]:
    """(the least seconds one H100 could take, which bound sets it)."""
    compute, memory = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (compute, "compute") if compute >= memory else (memory, "memory")
