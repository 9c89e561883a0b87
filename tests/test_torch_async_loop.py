"""The port's asynchronous loop worker (``loop.async_loop``), mirroring the
JAX package's tests/test_async_loop.py, on the CPU. Its card-only tests (a
capture beside a worker job, the worker's launch counts, the scan-to-map
graph pair) are in tests/test_torch_cuda_kernels.py, which runs on the card
without JAX.

Contracts, as the reference's:
1. draining the worker after every frame reproduces the synchronous run
   bitwise (keyframes, loop edges, the solved graph, both trajectories);
2. the merge keeps the worker's solved poses for the keyframes it saw and
   re-chains later keyframes' odometry edges onto them (against the JAX
   package's ``_merge_chain``);
3. one job in flight: a keyframe that finds the worker busy is skipped and
   counted;
4. a worker exception is raised on the frame's thread;
5. a result computed before a compaction is dropped.

The loop course is tests/test_torch_engine_loop.py's (66 frames at capacity
256, one loop closed at frame 64), float64.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu.core.config import EngineConfig as RefEngineConfig
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.core.config import EngineConfig, LoopConfig
from rivslam_tpu_torch.io import datasets, synthetic

from test_torch_engine_loop import IMU_CAP, LOOP_COURSE, _loop_cfg


def _async(cfg):
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, async_loop=True))


def test_async_drained_matches_sync_bitwise():
    seq, _ = synthetic.simulate_sequence(**LOOP_COURSE)
    cap = LOOP_COURSE["capacity"]
    cfg = _loop_cfg(presets, cap)
    eng_s = pipeline.Engine(cfg, dtype=torch.float64, device="cpu")
    eng_a = pipeline.Engine(_async(cfg), dtype=torch.float64, device="cpu")
    out_s = datasets.replay(eng_s, seq, cap, IMU_CAP)
    applied = []
    # drain after every frame: the worker's result merges before the next
    out_a = datasets.replay(eng_a, seq, cap, IMU_CAP, progress=lambda i, n: applied.append(eng_a.drain_loops()))
    assert [o["is_keyframe"] for o in out_s] == [o["is_keyframe"] for o in out_a]
    assert [bool(o["loop_found"]) for o in out_s] == [bool(a or o["loop_found"]) for o, a in zip(out_a, applied)]
    for key in ("odom", "pose"):
        np.testing.assert_array_equal(np.stack([o[key] for o in out_s]), np.stack([o[key] for o in out_a]))
    gs, ga = eng_s.state.graph, eng_a.state.graph
    assert int(gs.loop_mask.sum()) >= 1, "the course closed no loop; the contract is untestable"
    for name in ("loop_mask", "loop_i", "loop_j", "loop_rel_p", "R", "p"):
        assert torch.equal(getattr(gs, name), getattr(ga, name)), name
    for corrected in (True, False):
        np.testing.assert_array_equal(eng_s.trajectory(corrected)[1], eng_a.trajectory(corrected)[1])
    stats = dict(eng_a.loop_stats)
    assert stats == eng_s.loop_stats and stats["skipped_worker_busy"] == 0
    assert set(eng_a.timers.summary()) >= {"loop_detect_async", "graph_opt_async"}
    eng_a.close()


def _rot(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


@pytest.mark.parametrize("k_snap, count", [(2, 5), (4, 5), (6, 5), (0, 8)])
def test_merge_chain_matches_reference(k_snap, count):
    """Nodes <= k_snap take the solved poses, newer ones re-chain their
    odometry deltas onto them, slots >= count keep their live values: as
    the JAX engine's merge (a scan over every slot)."""
    K = 8
    rng = np.random.default_rng(3)
    live_R = np.stack([_rot(0.1 * i) for i in range(K)])
    live_p = rng.standard_normal((K, 3))
    solved_R = np.stack([_rot(-0.2 * i) for i in range(K)])
    solved_p = rng.standard_normal((K, 3))
    rel_R = np.stack([_rot(0.05 * i) for i in range(K)])
    rel_p = rng.standard_normal((K, 3))
    args = (live_R, live_p, solved_R, solved_p, rel_R, rel_p)
    ref = ref_pipeline.Engine(RefEngineConfig(), dtype=jnp.float64)
    want = ref._merge_chain(*map(jnp.asarray, args), jnp.asarray(k_snap), jnp.asarray(count))
    got = pipeline._merge_chain(*map(torch.as_tensor, args), k_snap, count)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    stop = min(k_snap + 1, count)
    np.testing.assert_array_equal(got[0].numpy()[:stop], solved_R[:stop])
    np.testing.assert_array_equal(got[1].numpy()[count:], live_p[count:])


def _engine():
    return pipeline.Engine(EngineConfig(loop=LoopConfig(async_loop=True)), dtype=torch.float64,
                           device="cpu")


def test_one_job_in_flight_skips_and_drains(monkeypatch):
    """While the worker is busy, a keyframe skips detection (the reference's
    timer overrun) and is counted; drain waits for the job in flight."""
    eng = _engine()
    release = threading.Event()
    seen = []

    def slow_detect(snap):
        seen.append(snap["k"])
        release.wait(timeout=10.0)
        return None

    monkeypatch.setattr(eng, "_run_loop_detection", slow_detect)
    eng._submit_loop_job({"k": 1, "epoch": 0})
    for _ in range(200):
        if seen:
            break
        time.sleep(0.01)
    assert seen == [1]
    eng._submit_loop_job({"k": 2, "epoch": 0})  # busy: skipped
    assert eng._loop_skipped == 1 and eng.loop_stats["skipped_worker_busy"] == 1
    release.set()
    assert eng.drain_loops() is False  # the detection found nothing
    assert not eng._loop_busy
    eng._submit_loop_job({"k": 3, "epoch": 0})  # free again after the drain
    eng.drain_loops()
    assert seen == [1, 3]
    eng.close()


def test_worker_exception_surfaces(monkeypatch):
    eng = _engine()

    def boom(snap):
        raise RuntimeError("loop worker exploded")

    monkeypatch.setattr(eng, "_run_loop_detection", boom)
    eng._submit_loop_job({"k": 1, "epoch": 0})
    with pytest.raises(RuntimeError, match="loop worker exploded"):
        eng.drain_loops()
    # the error is consumed; the engine keeps running
    assert eng.drain_loops() is False
    eng.close()


def test_stale_epoch_result_dropped(monkeypatch):
    """A result computed against a snapshot from before a compaction is
    dropped (its node indices no longer exist)."""
    eng = _engine()
    det = {"k": 5, "idx": 1, "epoch": 0}
    solved = type("G", (), {"R": None, "p": None})()
    monkeypatch.setattr(eng, "_run_loop_detection", lambda snap: det)
    monkeypatch.setattr(eng, "_add_loop_edge", lambda g, d: object())
    monkeypatch.setattr(eng, "_solve_graph", lambda g, timer="graph_opt": solved)
    accepted = []
    monkeypatch.setattr(eng, "_accept_loop", lambda d, solved=None: accepted.append(d) or True)
    eng.state.compact_epoch = 1  # a compaction happened while the job ran
    eng._submit_loop_job({"k": 5, "epoch": 0, "graph": None})
    assert eng.drain_loops() is False
    assert accepted == []
    # a result of the current epoch is merged
    det["epoch"] = 1
    eng._submit_loop_job({"k": 5, "epoch": 1, "graph": None})
    assert eng.drain_loops() is True and accepted == [det]
    eng.close()


def test_compaction_bumps_the_epoch():
    """Each compaction of the keyframe graph moves the epoch on."""
    cfg = _loop_cfg(presets, 128)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enable=False, keyframe_capacity=4))
    seq, _ = synthetic.simulate_sequence(**dict(LOOP_COURSE, n_frames=12, capacity=128))
    eng = pipeline.Engine(cfg, device="cpu")
    datasets.replay(eng, seq, 128, IMU_CAP)
    assert eng.state.compact_epoch >= 1 and eng.state.kf_count <= 4
