"""Device and numerics policy shared by the port's entry points."""

from __future__ import annotations

import torch


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
