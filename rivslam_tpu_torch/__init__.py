"""rivslam_tpu_torch — the PyTorch/CUDA port of rivslam_tpu for an NVIDIA H100.

It sits beside the JAX package, which stays the reference: every ported
module mirrors its counterpart's path (``core/``, ``ops/``, ``frontend/``,
``factors/``, ``solver/``, ``backend/``, ``io/``, ``eval/``,
``pipeline.py``) and is tested against it on the CPU. The port imports
torch and numpy, never jax and nothing of ``rivslam_tpu``.

Entry points (``entry``, ``frontend.apdgicp``, ``pipeline.Engine``) run on
the card (``device="cuda"``) unless the caller asks for the CPU. The
hand-written CUDA kernels live in ``csrc/`` and are built with nvcc on
first use (``ops/cuda_build.py``).
"""

__version__ = "0.1.0"

from rivslam_tpu_torch.core.device import set_full_f32 as _set_full_f32

_set_full_f32()


def entry(device="cuda"):
    """(fn, example_args): one FAST_APDGICP scan match (covariance
    estimation + LM registration) with the fused correspondence kernel K1
    on; the counterpart of the reference's ``__graft_entry__.entry()``."""
    import dataclasses

    import numpy as np
    import torch

    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.core.device import resolve
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.io import synthetic

    dev = resolve(device)
    cfg = dataclasses.replace(RegistrationConfig(), use_pallas_correspondence=True)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng, n_points=4000)
    T0 = np.eye(4)
    T0[:3, 3] = [0.0, 0.0, 2.0]
    T1 = T0.copy()
    T1[:3, 3] += [0.4, -0.2, 0.0]
    tgt = synthetic.observe(world, T0, rng, capacity=256, noise=0.01, device=dev)
    src = synthetic.observe(world, T1, rng, capacity=256, noise=0.01, device=dev)

    def fn(src_xyz, src_mask, tgt_xyz, tgt_mask, guess):
        return apdgicp.prepare_and_register(
            src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg, device=dev
        )

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return fn, (src.xyz, src.mask, tgt.xyz, tgt.mask, eye)
