"""The roofline counts of K1-K3 on hand-sized inputs.

    python -m pytest benchmark/tests/test_bench_roofline.py -q -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import roofline  # noqa: E402


def test_valid_pairs_sum_over_problems():
    # problem 0: 3 valid queries x 2 valid targets; problem 1: 1 x 4
    assert roofline.valid_pairs([3, 1], [2, 4]) == 3 * 2 + 1 * 4


def test_k1_counts_by_hand():
    # B=2, N=4, M=5, F=9; valid queries [3, 1], valid targets [2, 4]
    ops, nbytes = roofline.k1_work(2, 4, 5, 9, [3, 1], [2, 4])
    assert ops == 8 * 10
    read = 4 * 2 * 4 * 3 + 4 * 2 * 5 * 3 + 1 * 2 * 5 + 4 * 2 * 9 * 5  # query, ref, mask, features
    written = 4 * 2 * 4 + 4 * 2 * 9 * 4  # d2, gathered features
    assert nbytes == read + written == 96 + 120 + 10 + 360 + 32 + 288


def test_k2_k3_counts_by_hand():
    ops, nbytes = roofline.k2_work(1, 2, 3, 12, [2], [3])
    assert ops == 8 * 6
    assert nbytes == 4 * 2 * 3 + 4 * 3 * 3 + 3 + 4 * 3 * 12 + 4 * 2 + 4 * 2 + 4 * 2 * 12
    ops, nbytes = roofline.k3_work(1, 2, 3, [2], [1])
    assert ops == 8 * 2
    assert nbytes == 4 * 2 * 3 + 4 * 3 * 3 + 3 + 4 * 2 + 4 * 2


def test_least_time_takes_the_larger_bound():
    # K1 at the scan-match batch, every point valid: bounded by compute
    B, N = 256, 1024
    ops, nbytes = roofline.k1_work(B, N, N, 9, [N] * B, [N] * B)
    t, bound = roofline.least_time_s(ops, nbytes)
    assert bound == "compute"
    assert t == pytest.approx(8 * B * N * N / 67e12)
    assert nbytes / 3.35e12 < t
    # one problem with one valid target: bounded by the bytes
    ops, nbytes = roofline.k1_work(1, N, N, 9, [N], [1])
    t, bound = roofline.least_time_s(ops, nbytes)
    assert bound == "memory" and t == pytest.approx(nbytes / 3.35e12)
