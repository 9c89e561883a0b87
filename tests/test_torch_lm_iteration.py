"""The registration's LM/GN loop as fixed-count, masked functions
(``apdgicp.lm_iteration``: one outer iteration, always ``lm_max_iterations``
lambda tries ``lm_try``), iterated eagerly on the CPU, against the JAX
package's ``register_fast`` and ``register`` on the same numpy-seeded
inputs; and the masking: a try or an iteration past done changes nothing.

On the card the Engine replays exactly these functions as CUDA graphs
(``apdgicp.GraphedRegistration``; tests/test_torch_cuda_kernels.py holds the
replays bitwise to an eager run).

Tolerances: float64 holds T within 1e-10 and H, the error and the fitness
within a relative 1e-10 (the two packages sum H and b in other orders, a
few ulps); float32 holds T within 1e-3 with equal iterations, convergence
and correspondences, as tests/test_torch_apdgicp.py holds the scan match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu.core.config import RegistrationConfig as RefConfig
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp, apdgicp_fast
from rivslam_tpu_torch.io import synthetic

CAPACITY = 256
T_ATOL = {"f64": 1e-10, "f32": 1e-3}
REL_F64 = 1e-10
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
PATHS = {"fast": (apdgicp_fast.fast_problem, apdgicp_fast.fast_model),
         "exact": (apdgicp.exact_problem, apdgicp.exact_model)}


@pytest.fixture(scope="module")
def pairs():
    """bench.py's protocol at a small size: 2 consecutive frame pairs at
    capacity 256, numpy."""
    src_xyz, src_mask, tgt_xyz, tgt_mask, _ = synthetic.load_pairs(2, CAPACITY, device="cpu")
    return [t.numpy() for t in (src_xyz, src_mask, tgt_xyz, tgt_mask)]


def _prepared(pairs, cfg, dtype):
    """Both clouds prepared once by the reference (in ``dtype``), handed to
    both packages: JAX PreparedClouds per problem, torch ones batched."""
    np_dt, t_dt = DTYPES[dtype]
    src_xyz, src_mask, tgt_xyz, tgt_mask = pairs
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    prep = jax.jit(jax.vmap(lambda x, m: ref_apdgicp.prepare(x, m, rcfg)))
    ref = [prep(jnp.asarray(x.astype(np_dt)), jnp.asarray(m)) for x, m in ((src_xyz, src_mask), (tgt_xyz, tgt_mask))]

    def torch_cloud(c):
        return apdgicp.PreparedCloud(
            xyz=torch.as_tensor(np.array(c.xyz), dtype=t_dt), mask=torch.as_tensor(np.array(c.mask)),
            cov=torch.as_tensor(np.array(c.cov), dtype=t_dt))

    return ref, [torch_cloud(c) for c in ref], rcfg


def _iterate(path, source, target, T0, cfg):
    """The loop by hand: ``lm_iteration`` until no problem is active (one
    host read per iteration), then the final correspondence step."""
    problem_fn, model_fn = PATHS[path]
    linearize_at, error_at, final_at = model_fn(*problem_fn(source, target), cfg)
    carry = apdgicp.lm_init(T0, cfg)
    for _ in range(cfg.max_iterations):
        carry = apdgicp.lm_iteration(carry, cfg, linearize_at, error_at)
        if not bool(apdgicp.lm_active(carry, cfg).any()):
            break
    return carry, final_at(carry[0])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("optimizer", ["LM", "GN"])
@pytest.mark.parametrize("method", ["FAST_APDGICP", "GICP"])
@pytest.mark.parametrize("path", ["fast", "exact"])
def test_iterated_lm_iteration_matches_reference(pairs, path, method, optimizer, dtype):
    """``lm_iteration`` iterated by hand over two problems equals the JAX
    register_fast (fast path) or register (exact path), vmapped, and the
    port's own ``run_registration`` bitwise."""
    cfg = RegistrationConfig(method=method, optimizer=optimizer, use_fast_path=path == "fast")
    (rsrc, rtgt), (src, tgt), rcfg = _prepared(pairs, cfg, dtype)
    np_dt, t_dt = DTYPES[dtype]
    guess = np.broadcast_to(np.eye(4, dtype=np_dt), (2, 4, 4)).copy()
    want = jax.jit(jax.vmap(lambda s, t, g: ref_apdgicp.register_dispatch(s, t, g, rcfg)))(
        rsrc, rtgt, jnp.asarray(guess))
    carry, (error, ncorr, fitness) = _iterate(path, src, tgt, torch.as_tensor(guess), cfg)
    T, _, converged, _, it, H = carry
    np.testing.assert_allclose(T.numpy(), np.asarray(want.T), rtol=0, atol=T_ATOL[dtype])
    np.testing.assert_array_equal(it.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(ncorr.numpy(), np.asarray(want.num_correspondences))
    if dtype == "f64":
        for got, ref in ((H, want.H), (error, want.error), (fitness, want.fitness)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=REL_F64, atol=REL_F64 * np.abs(ref).max())
    res = apdgicp.run_registration(PATHS[path][1], PATHS[path][0](src, tgt), torch.as_tensor(guess), cfg)
    for a, b in ((res.T, T), (res.H, H), (res.iterations, it), (res.converged, converged),
                 (res.error, error), (res.num_correspondences, ncorr), (res.fitness, fitness)):
        assert torch.equal(a, b)


def _far_guess():
    """Problem 0 from identity, problem 1 from 15 degrees and 0.8 m off: the
    two finish their lambda searches and their iterations at different
    times."""
    xi = torch.tensor([0.0, 0.0, 0.26, 0.8, -0.3, 0.05], dtype=torch.float64)
    return torch.stack([torch.eye(4, dtype=torch.float64), lie.se3_exp(xi)])


def _unchanged_where(done: torch.Tensor, before: tuple, after: tuple) -> bool:
    return all(torch.equal(a[done], b[done]) for a, b in zip(before, after))


@pytest.mark.parametrize("path", ["fast", "exact"])
def test_tries_past_done_leave_the_carry_bitwise_unchanged(pairs, path):
    """Every lambda try leaves the tries' state of a problem whose search is
    done (a try accepted, or the rejected step converged) bitwise
    unchanged; all searches are done before the last try, so the tries
    after it change nothing at all."""
    cfg = RegistrationConfig(use_fast_path=path == "fast")
    _, (src, tgt), _ = _prepared(pairs, cfg, "f64")
    problem_fn, model_fn = PATHS[path]
    linearize_at, error_at, _ = model_fn(*problem_fn(src, tgt), cfg)
    T = _far_guess()
    H, b, y0, ctx = linearize_at(T)
    diag_max = torch.amax(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1)
    tries = (T, cfg.lm_init_lambda_factor * diag_max, torch.full((2,), 2.0, dtype=T.dtype),
             torch.zeros(2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool),
             torch.zeros(2, dtype=torch.bool), torch.eye(4, dtype=T.dtype).expand(2, 4, 4))
    done_at = []
    for _ in range(cfg.lm_max_iterations + 3):
        done = tries[3].clone()
        new = apdgicp.lm_try(tries, H, b, y0, T, ctx, cfg, error_at)
        assert _unchanged_where(done, tries, new)
        done_at.append(int(done.sum()))
        tries = new
    assert done_at[-1] == 2 and done_at.index(2) <= cfg.lm_max_iterations


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
@pytest.mark.parametrize("path", ["fast", "exact"])
def test_iterations_past_done_leave_the_carry_bitwise_unchanged(pairs, path, optimizer):
    """An outer iteration leaves a problem that is no longer active bitwise
    unchanged, while the other problem still iterates; iterations after
    both are done change nothing."""
    cfg = RegistrationConfig(use_fast_path=path == "fast", optimizer=optimizer)
    _, (src, tgt), _ = _prepared(pairs, cfg, "f64")
    problem_fn, model_fn = PATHS[path]
    linearize_at, error_at, _ = model_fn(*problem_fn(src, tgt), cfg)
    carry = apdgicp.lm_init(_far_guess(), cfg)
    inactive_seen = []
    for _ in range(cfg.max_iterations):
        inactive = ~apdgicp.lm_active(carry, cfg)
        new = apdgicp.lm_iteration(carry, cfg, linearize_at, error_at)
        assert _unchanged_where(inactive, carry, new)
        inactive_seen.append(int(inactive.sum()))
        carry = new
        if inactive_seen[-1] == 2:
            break
    assert inactive_seen[-1] == 2 and 1 in inactive_seen  # a mixed iteration was checked
