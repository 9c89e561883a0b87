"""Robust kernels as IRLS weights rho'(chi2) on whitened residual blocks
(port of ``rivslam_tpu/factors/robust.py``; g2o's RobustKernel* scaling)."""

from __future__ import annotations

import torch


def kernel_weight(name: str, delta: float, chi2: torch.Tensor) -> torch.Tensor:
    """Weight rho'(chi2) of kernel ``name``; chi2 is the edge's squared
    whitened residual norm."""
    d2 = delta * delta
    if name == "NONE":
        return torch.ones_like(chi2)
    if name == "Huber":
        return torch.where(chi2 <= d2, 1.0, delta / torch.sqrt(torch.clamp_min(chi2, 1e-30)))
    if name == "Cauchy":
        return 1.0 / (1.0 + chi2 / d2)
    if name == "GemanMcClure":
        return (d2 / (d2 + chi2)) ** 2
    if name == "Welsch":
        return torch.exp(-chi2 / d2)
    if name == "Fair":
        return 1.0 / (1.0 + torch.sqrt(torch.clamp_min(chi2, 1e-30)) / delta)
    if name == "DCS":
        return torch.clamp_max((2.0 * delta / (delta + chi2)) ** 2, 1.0)
    if name == "Saturated":
        return torch.where(chi2 <= d2, 1.0, d2 / torch.clamp_min(chi2, 1e-30))
    if name == "Tukey":
        u = 1.0 - chi2 / d2
        return torch.where(chi2 <= d2, u * u, 0.0)
    if name == "PseudoHuber":
        return 1.0 / torch.sqrt(1.0 + chi2 / d2)
    raise ValueError(f"unknown robust kernel {name}")
