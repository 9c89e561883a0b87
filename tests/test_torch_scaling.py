"""The port's scaling harness (``rivslam_tpu_torch/eval/scaling.py``) on
the CPU, mirroring tests/test_scaling.py: at the JAX smoke test's sizes, a
world of 1 and one of 2 gloo ranks run every row, and each distributed
solver reaches its local twin's chi2."""

import jax.numpy as jnp
import numpy as np
import torch

import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu.eval import scaling as ref_scaling
from rivslam_tpu_torch.eval import scaling
from rivslam_tpu_torch.loop import block_schur


def test_scaling_harness_runs_and_matches():
    out = scaling.run_scaling(scaling._counts("2"), frames=4, capacity=64, graph_k=64, repeats=1, gn_iters=3,
                              imu_capacity=8, pin_fleet=False, device="cpu")
    assert out["rank_counts"] == [1, 2] and out["platform"] == "cpu-gloo"
    assert out["local"]["schur_blocks"] >= 2
    rows = out["scaling"]
    assert [row["ranks"] for row in rows] == [1, 2]
    for row in rows:
        assert row["fleet"]["aggregate_fps"] > 0
        assert row["sharded_register"]["ms"] > 0
        assert row["dist_pcg"]["chi2_matches_local"], row["dist_pcg"]
        assert "skipped" not in row["dist_schur"], row["dist_schur"]
        assert row["dist_schur"]["chi2_matches_local"], row["dist_schur"]
        assert row["schur_phases"]["per_rank_total_ms"] > 0
    assert "collective" in rows[1] and rows[1]["fleet"]["sequences"] == 2
    assert out["chi2_mismatches"] == []


def test_schur_blocks_fallback_for_non_dividing_counts():
    """A world size that does not divide the default submap count still
    gets a valid partition: a divisor of the capacity that is a multiple of
    the world size."""
    nb = scaling._schur_blocks(60, block_schur.effective_blocks(60, 16), 3)
    assert nb is not None and nb % 3 == 0 and 60 % nb == 0
    assert scaling._schur_blocks(64, 16, 2) == 16
    assert scaling._counts("4") == [1, 2, 4] and scaling._counts("3") == [1, 2, 3]
    assert scaling._counts("1,4") == [1, 4]


def test_drifted_loop_graph_matches_reference():
    got = scaling._drifted_loop_graph(64, 8, 56, torch.float64)
    want = ref_scaling._drifted_loop_graph(64, 8, 56, jnp.float64)
    for name in ("R", "p", "node_mask", "odom_rel_R", "odom_rel_p", "odom_info", "loop_i", "loop_j",
                 "loop_rel_R", "loop_rel_p", "loop_info", "loop_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
