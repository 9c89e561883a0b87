"""The reference against a second witness at the cells' shapes, on the CPU,
in float64: the parts of the check written from the methods
(``reference/gicp.py``, ``reference/pose_graph.py``) against the frozen
copy and the port, and the frozen copy's ego velocity and window backend
against ``witness.py``, which shares no code with either.

- registration: ``gicp``'s error at the port's answers equals the frozen
  fast path's, its covariances the frozen prepare's (the median point), and
  the Gauss-Newton step from a converged answer is under the stopping rule;
- global solve: the port's block-Schur solve in float64 reaches
  ``pose_graph``'s minimum;
- ego velocity: the frozen REVE and the witness's agree on the frames of
  each stream cell, from the same scan and RANSAC draws;
- window backend: from the port's state before a frame and its odometry
  pose, the witness's chi2 at the frozen backend's answer is the chi2 the
  frozen backend reports, and the witness's Levenberg-Marquardt, as the
  backend configures it, reaches the frozen backend's answer.

    python -m pytest benchmark/tests/test_bench_witness.py -q -p no:cacheprovider
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import convert, gicp, pose_graph  # noqa: E402
from benchmark.reference.plain.ops import filters  # noqa: E402
from benchmark.runners import scan_match, stream  # noqa: E402
from benchmark.tests import witness  # noqa: E402
from benchmark.tests.test_bench_reference import _ring_graph  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64
SEED = 2**36 + 5


@pytest.fixture(scope="module")
def systems():
    torch.set_num_threads(4)
    return harness.program_system(), harness.reference_system()


def test_registration_at_the_cells_shapes(systems):
    prog, ref = systems
    cell = harness.load_cell("cp.scan_match")
    B = 4
    tr = {**cell.traffic, "batch": B, "batches": 1}  # capacity 1024, as the cell
    host = scan_match.make_batches(cell.config, tr)[0]
    reg_cfg = harness.engine_config(cell.config["engine"], prog.config).registration
    ref_cfg = harness.engine_config(cell.config["engine"], ref.config).registration
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    guess = torch.eye(4).expand(B, 4, 4).contiguous()
    src, tgt, res, _ = scan_match.register_batch(prog, reg_cfg, batch, guess, CPU)
    src64, tgt64 = (convert.to_reference(c, F64, CPU) for c in (src, tgt))
    from benchmark.reference.plain.frontend import apdgicp_fast as frozen

    want = frozen.fast_model(*frozen.fast_problem(src64, tgt64), ref_cfg)[2](res.T.double())[0]
    got = gicp.Problem(src64.xyz, src64.mask, src64.cov, tgt64.xyz, tgt64.mask, tgt64.cov, ref_cfg).error(res.T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    # covariances of the raw scans: the median point agrees to rounding
    cov = gicp.rbf_covariances(batch["src_xyz"], batch["src_mask"], ref_cfg.rbf_kernel_width, ref_cfg.rbf_max_dist)
    frozen_cov = ref.apdgicp.prepare(batch["src_xyz"].double(), batch["src_mask"], ref_cfg, device=CPU).cov
    gaps = scan_match.cov_gaps(cov.numpy(), frozen_cov.numpy(), host["src_mask"])
    assert np.median(gaps) < 1e-9
    # a converged answer's next step is under the stopping rule
    problem = gicp.Problem(src64.xyz, src64.mask, src64.cov, tgt64.xyz, tgt64.mask, tgt64.cov, ref_cfg)
    assert bool(res.converged.all())
    assert float(problem.step_units(res.T).max()) < 1.0
    assert float(problem.step_units(guess).min()) > 1.0


def test_global_solve_reaches_the_minimum():
    from rivslam_tpu_torch.loop import block_schur, global_graph

    g = _ring_graph(global_graph, n=40, capacity=2048)  # the cells' keyframe capacity
    g64 = dataclasses.replace(g, **{f.name: getattr(g, f.name).double() for f in dataclasses.fields(g)
                                    if getattr(g, f.name).is_floating_point()})
    solved, _ = block_schur.solve_pose_graph_schur(g64, num_blocks=32)
    graph = pose_graph.Graph(g64)
    _, best_p, best = graph.minimize()
    assert float((solved.p[:graph.n] - best_p).norm(dim=-1).max()) < 1e-6
    assert graph.excess(solved.R, solved.p) < 1e-9
    assert graph.excess(g64.R, g64.p) > 1.0  # the unsolved graph lies far above it


def _state_dict(st) -> dict:
    """The frozen BackendState as the witness takes it."""
    out = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st) if f.name not in ("nav", "preint")}
    out.update({f.name: getattr(st.nav, f.name).numpy() for f in dataclasses.fields(st.nav)})
    out["preint"] = {f.name: getattr(st.preint, f.name).numpy() for f in dataclasses.fields(st.preint)}
    return out


@pytest.mark.parametrize("workload", ["cp.stream", "garden.stream"])
def test_ego_velocity_and_backend(workload, systems):
    prog, ref = systems
    cell = harness.load_cell(workload)
    tr = dict(cell.traffic)  # capacity 1024, IMU buffers of 64, as the cell
    cfg = harness.engine_config(cell.config["engine"], ref.config)
    n, check = 9, (7, 8)  # the window of 6 full before the checked frames
    course = stream.course_for(cell.config, SEED, n)
    eng = prog.pipeline.Engine(harness.engine_config(cell.config["engine"], prog.config), seed=SEED, device=CPU)
    for i in range(n):
        snap = convert.clone({"backend": eng.state.backend, "floor_prev": eng.state.floor_prev})
        out = stream.hand_over(eng, prog, stream.frame_inputs(course, i, tr["capacity"], tr["imu_capacity"]))
        if i not in check:
            continue
        s = convert.to_reference(snap, F64, CPU)
        cloud, (ang, stamp, dts, acc, gyr, m) = stream._frame_tensors(course, i, tr, ref, F64, CPU)
        draws = stream.frame_draws(ref, SEED, i, ref.frame.draw_shapes(cfg, tr["capacity"]), F64, CPU)
        cl, ego, fl, _ = ref.frame.preprocess(cfg, cloud, ang, s["floor_prev"], draws)
        # REVE's input: the scan after the NaN and power filters
        rin = filters.power_filter(filters.nan_filter(cloud), cfg.preprocess.power_threshold)
        v, sigma, ok, inl = witness.ego_velocity(rin.xyz.numpy(), rin.doppler.numpy(), rin.intensity.numpy(),
                                                 rin.mask.numpy(), cfg.reve, draws[0].numpy())
        np.testing.assert_allclose(v, ego.v.numpy(), atol=1e-10, err_msg=f"frame {i}")
        np.testing.assert_allclose(sigma, ego.sigma.numpy(), rtol=1e-8, atol=1e-12)
        assert ok == bool(ego.success)
        np.testing.assert_array_equal(inl, ego.inlier_mask.numpy())

        pose = torch.as_tensor(np.asarray(out["odom"]), dtype=F64)
        frame = ref.slam.BackendFrame(
            stamp=stamp, odom_R=pose[:3, :3], odom_p=pose[:3, 3], xyz=cl.xyz, mask=cl.mask, ego_vel=ego.v,
            ego_vel_cov=ego.sigma**2, imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=m, floor=fl.coeffs,
            floor_valid=fl.found)
        new, bout = ref.slam.backend_step(s["backend"], frame, cfg.backend, cfg.imu)
        assert not bool(bout.failure)
        win = witness.Window(_state_dict(s["backend"]), {k: (v_.numpy() if hasattr(v_, "numpy") else v_)
                                                        for k, v_ in vars(frame).items()}, cfg.backend, cfg.imu)
        answer = [getattr(new.nav, k).numpy() for k in ("R", "p", "v", "bg", "ba")]
        assert win.chi2(answer) == pytest.approx(float(bout.chi2), rel=1e-8)
        x, chi2 = win.solve()
        assert chi2 == pytest.approx(float(bout.chi2), rel=1e-7)
        assert np.linalg.norm(x[1][-1] - bout.pose[:3, 3].numpy()) < 1e-7
        assert witness.log(x[0][-1].T @ bout.pose[:3, :3].numpy()) == pytest.approx(np.zeros(3), abs=1e-8)
        # the LM's cap of 8 iterations leaves the answer short of the objective's minimum
        x_min, best = win.minimize()
        print(f"{workload} frame {i}: objective at the backend's answer over its minimum "
              f"{(win.objective(answer) - best) / best:.3e}, newest position "
              f"{np.linalg.norm(x_min[1][-1] - bout.pose[:3, 3].numpy()):.3e} m from the minimum's")
