"""Device and numerics policy shared by the port's entry points."""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Keep every float32 product in full float32 (no TF32).

    The |p|^2 + |t|^2 - 2 p.t distance form needs the cancellation headroom
    of a full 24-bit mantissa at 30 m coordinate scale, and chained pose
    products drift off SO(3) at reduced precision (reasons recorded in the
    reference at rivslam_tpu/__init__.py and core/config.py).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist.

    Entry points default to ``"cuda"``; callers that want the CPU (the
    tests) ask for it with ``device="cpu"``. There is no silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rivslam_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
