"""The benchmark's frozen reference against the port on the CPU, at a small
size: in float32 the frozen copy computes what the port computes, bit for
bit (a frame's preprocessing and window backend from the port's own state,
a batch of scan matches), and it loads nothing of the port.

    python -m pytest benchmark/tests/test_bench_reference.py -q -p no:cacheprovider
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.runners import scan_match, stream  # noqa: E402
from benchmark.reference import convert  # noqa: E402

CPU = torch.device("cpu")
CAPACITY = 256
SEED = 2**40 + 3


@pytest.fixture(scope="module")
def systems():
    return harness.program_system(), harness.reference_system()


def _frames(cell, systems, n_frames: int, check_from: int):
    """Run the port's engine over the course's first frames; keep its state
    before each frame from ``check_from`` on, and the frame's outputs."""
    prog, _ = systems
    tr = {**cell.traffic, "capacity": CAPACITY}
    course = stream.course_for(cell.config, SEED, n_frames)
    eng = prog.pipeline.Engine(harness.engine_config(cell.config["engine"], prog.config), seed=SEED, device=CPU)
    kept = []
    for i in range(n_frames):
        snap = convert.clone({"backend": eng.state.backend, "floor_prev": eng.state.floor_prev})
        out = stream.hand_over(eng, prog, stream.frame_inputs(course, i, CAPACITY, tr["imu_capacity"]))
        if i >= check_from:
            kept.append((i, snap, out))
    return course, tr, kept


@pytest.mark.parametrize("workload", ["cp.stream", "garden.stream"])
def test_preprocess_and_backend_are_the_ports(workload, systems):
    """The frame's preprocessing and window backend, from the port's state
    before it and fed the port's own odometry pose, give the port's ego
    velocity, window pose and chi2."""
    cell = harness.load_cell(workload)
    _, ref = systems
    cfg = harness.engine_config(cell.config["engine"], ref.config)
    course, tr, kept = _frames(cell, systems, 4, 2)
    for i, snap, out in kept:
        want = stream.reference_frame(ref, cfg, snap, course, i, SEED, tr, out["odom"], torch.float32, CPU)
        for key in ("ego_velocity", "pose"):
            np.testing.assert_array_equal(want[key], out[key], err_msg=f"frame {i} {key}")
        assert want["chi2"] == out["chi2"]
        # and in float64 the ego velocity, a well-conditioned solve, agrees closely
        want64 = stream.reference_frame(ref, cfg, snap, course, i, SEED, tr, out["odom"], torch.float64, CPU)
        np.testing.assert_allclose(want64["ego_velocity"], out["ego_velocity"], atol=1e-4)


def test_scan_match_is_the_ports(systems):
    """The frozen prepare and registration, which the control runs in the
    program's place, are the port's."""
    prog, ref = systems
    cell = harness.load_cell("cp.scan_match")
    tr = {**cell.traffic, "batch": 3, "batches": 1, "capacity": CAPACITY}
    host = scan_match.make_batches(cell.config, tr)[0]
    reg_cfg = harness.engine_config(cell.config["engine"], prog.config).registration
    ref_cfg = harness.engine_config(cell.config["engine"], ref.config).registration
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    guess = torch.eye(4).expand(3, 4, 4).contiguous()
    src, tgt, res, T = scan_match.register_batch(prog, reg_cfg, batch, guess, CPU)
    r_src, r_tgt, r_res, r_T = scan_match.register_batch(ref, ref_cfg, batch, guess, CPU)
    np.testing.assert_array_equal(r_T, T)
    np.testing.assert_array_equal(r_src.cov.numpy(), src.cov.numpy())
    np.testing.assert_array_equal(r_res.error.numpy(), res.error.numpy())
    # prepares in blocks of pairs: independent problems
    blocks = scan_match.reference_prepare(ref, ref_cfg, host, 2, torch.float32, CPU)
    np.testing.assert_array_equal(torch.cat([p.cov for p in blocks[1]]).numpy(), tgt.cov.numpy())
    # the reported error is the error at the answer, as the check recomputes it
    err = harness.registration_error(ref_cfg, convert.to_reference(src, torch.float64, CPU),
                                     convert.to_reference(tgt, torch.float64, CPU), res.T.double())
    np.testing.assert_allclose(err.numpy(), res.error.numpy(), rtol=1e-4)


def _ring_graph(module, n: int = 24, capacity: int = 64):
    """A drifted ring: odometry edges with a bias, node estimates chained
    from them, and a loop edge from the last node back to the first."""
    g = module.PoseGraph.create(capacity, 8, dtype=torch.float32)
    rng = np.random.default_rng(4)
    ang = 2 * np.pi / n
    R = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     dtype=torch.float32)
    step = torch.tensor([1.0, 0.0, 0.0])
    Rs, ps = [torch.eye(3)], [torch.zeros(3)]
    for _ in range(1, n):
        drift = torch.as_tensor(rng.normal(size=3) * 0.02, dtype=torch.float32)
        ps.append(Rs[-1] @ (step + drift) + ps[-1])
        Rs.append(Rs[-1] @ R)
    odom_R = torch.stack([torch.eye(3)] + [R] * (n - 1))
    odom_p = torch.stack([torch.zeros(3)] + [Rs[k - 1].T @ (ps[k] - ps[k - 1]) for k in range(1, n)])

    def rows(t, k, v):
        t = t.clone()
        t[:k] = v
        return t

    return module.PoseGraph(
        **{**{f: getattr(g, f) for f in g.__dataclass_fields__},
           "R": rows(g.R, n, torch.stack(Rs)), "p": rows(g.p, n, torch.stack(ps)),
           "node_mask": rows(g.node_mask, n, True), "odom_rel_R": rows(g.odom_rel_R, n, odom_R),
           "odom_rel_p": rows(g.odom_rel_p, n, odom_p),
           "loop_i": rows(g.loop_i, 1, 0), "loop_j": rows(g.loop_j, 1, n - 1),
           "loop_rel_R": rows(g.loop_rel_R, 1, R.T), "loop_rel_p": rows(g.loop_rel_p, 1, torch.tensor([-1.0, 0, 0])),
           "loop_mask": rows(g.loop_mask, 1, True)})


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.plain.frame, benchmark.reference.plain.frontend.apdgicp\n"
        "import benchmark.reference.plain.backend.slam, benchmark.reference.gicp, benchmark.reference.pose_graph\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'rivslam_tpu_torch', 'rivslam_tpu', 'jax'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % ROOT
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
