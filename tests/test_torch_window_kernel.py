"""The window solve's routing on the CPU: ``solver/window.solve`` runs the
kernel's plain twin (``solve_window``) for CPU tensors and launches
nothing; the kernel wrapper's checks refuse what the kernel cannot take
before any launch (the most slots its shared memory holds is the
library's to say, and is checked on the card); the twin's lambda-try
count; and the tracer's
``lm_iterations`` and ``lm_tries`` counters, keyed under
``backend.window_solve``. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py)."""

import dataclasses

import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)
from torch_window_problem import BIAS_INFO, make_window

from rivslam_tpu_torch.backend import slam
from rivslam_tpu_torch.core import config
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.solver import window


@pytest.fixture(scope="module")
def problem():
    return make_window(dtype=torch.float32)


def _batched(x, f):
    return window._lead1(x), window._lead1(f)


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
def test_solve_routes_cpu_tensors_to_the_twin(problem, optimizer):
    x0, f = problem
    cfg = dataclasses.replace(config.BackendConfig(), optimizer=optimizer)
    launches = window.solve_batched.launches
    x, chi2, it, tries = window.solve(x0, f, cfg, BIAS_INFO)
    xt, chi2_t, it_t, tries_t = window.solve_window(x0, f, cfg, BIAS_INFO)
    assert (it, tries) == (it_t, tries_t) and torch.equal(chi2, chi2_t)
    for a, b in zip(x.astuple(), xt.astuple()):
        assert torch.equal(a, b)
    solver = window.FusedSolver(cfg, BIAS_INFO, torch.float32)
    xs, chi2_s, it_s, tries_s = solver(x0, f)
    assert (it_s, tries_s) == (it, tries) and torch.equal(chi2_s, chi2) and torch.equal(xs.p, x.p)
    assert solver.replays == 0 and window.solve_batched.launches == launches
    assert (solver.iterations, solver.tries) == (it, tries)


def test_twin_counts_its_lambda_tries(problem):
    """GN makes one try an iteration; LM at least one; the Engine's first
    frame (one valid slot: H = 0, lambda = 0, so every damped system fails
    its factorization) stops after one iteration of 8 rejected tries with
    the state unchanged."""
    x0, f = problem
    base = config.BackendConfig()
    _, _, it, tries = window.solve_window(x0, f, dataclasses.replace(base, optimizer="GN"), BIAS_INFO)
    assert tries == it >= 2
    _, _, it, tries = window.solve_window(x0, f, base, BIAS_INFO)
    assert it <= tries <= window.INNER_TRIES * it
    first = dataclasses.replace(f, frame_mask=torch.tensor([False] * 5 + [True]))
    x, chi2, it, tries = window.solve_window(x0, first, base, BIAS_INFO)
    assert (it, tries) == (1, window.INNER_TRIES) and float(chi2) == 0.0
    for a, b in zip(x.astuple(), x0.astuple()):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take(problem):
    x0, f = problem
    xb, fb = _batched(x0, f)
    assert window.check(xb, fb) == (1, 6)
    empty = dataclasses.replace(xb, **{k: v[:, :0] for k, v in dataclasses.asdict(xb).items()})
    with pytest.raises(ValueError, match="no slot"):
        window.check(empty, fb)
    half = dataclasses.replace(xb, **{k: v.half() for k, v in dataclasses.asdict(xb).items()})
    with pytest.raises(ValueError, match="float32 or float64"):
        window.check(half, fb)
    with pytest.raises(ValueError, match="must be torch.float32"):
        window.check(xb, dataclasses.replace(fb, rel_info=fb.rel_info.double()))
    with pytest.raises(ValueError, match=r"\[B=1, W=6"):
        window.check(xb, dataclasses.replace(fb, vel_info=fb.vel_info[:, :5]))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        window.solve_batched(xb, fb, config.BackendConfig(), BIAS_INFO)
    with pytest.raises(ValueError, match="unknown robust kernel"):
        window.FusedSolver(dataclasses.replace(config.BackendConfig(), floor_edge_robust_kernel="L1"),
                           BIAS_INFO, torch.float32)


def test_window_solve_counters_are_keyed_under_its_span(problem):
    """The tracer counts the solve's outer iterations and lambda tries under
    the span open around the call: ``backend.window_solve`` in
    ``backend_step``, apart from the registration's ``apdgicp.solve_lm``."""
    x0, f = problem
    cfg = config.BackendConfig()
    tracer = timing.StageTimers().on()
    try:
        with tracer.span("backend.window_solve"):
            _, _, it, tries = window.solve(x0, f, cfg, BIAS_INFO)
        totals = tracer.totals()
    finally:
        tracer.off()
    assert (it, tries) == window.solve_window(x0, f, cfg, BIAS_INFO)[2:]
    assert totals["lm_iterations"] == {"backend.window_solve": it}
    assert totals["lm_tries"] == {"backend.window_solve": tries}


def test_backend_step_counts_the_window_solve_per_frame():
    """backend_step's solve on the CPU: each frame record counts its
    iterations (the frame's BackendOutput.iterations) and tries under
    ``backend.window_solve``."""
    bk, imu = config.BackendConfig(), config.ImuConfig()
    st = slam.init_state(bk, imu, 64, torch.float32, "cpu")
    x0, f = make_window(dtype=torch.float32)
    tracer = timing.StageTimers().on()
    iters = []
    try:
        for i in range(3):
            frame = slam.BackendFrame(
                stamp=torch.tensor(0.1 * i), odom_R=x0.R[i], odom_p=x0.p[i], xyz=torch.zeros(64, 3),
                mask=torch.zeros(64, dtype=torch.bool), ego_vel=x0.v[i], ego_vel_cov=torch.full((3,), 1e-3),
                imu_dts=torch.full((8,), 0.005), imu_acc=torch.tensor([[0.0, 0.0, 9.8]]).expand(8, 3),
                imu_gyr=torch.zeros(8, 3), imu_mask=torch.ones(8, dtype=torch.bool),
                floor=f.plane_meas[i], floor_valid=torch.tensor(True))
            with tracer.frame(i):
                st, out = slam.backend_step(st, frame, bk, imu)
            iters.append(out.iterations)
        frames = tracer.frames()
    finally:
        tracer.off()
    assert [fr["counters"]["lm_iterations"] for fr in frames] == [{"backend.window_solve": n} for n in iters]
    for fr, n in zip(frames, iters):
        assert set(fr["counters"]["lm_tries"]) == {"backend.window_solve"}
        assert n <= fr["counters"]["lm_tries"]["backend.window_solve"] <= window.INNER_TRIES * n
