"""The capture rule on the CPU (``core/cuda_graph.GraphCache``) through its
users: ``frontend/apdgicp.GraphedRegistration`` (a key's ``capture_on``-th
registration captures, the ones before run eagerly, later ones replay), the
bound on keys, the loop worker's deferred capture, the tracer's
``registrations_graphed`` / ``registrations_eager`` counters, that the CPU
path makes no store, and the backend's preintegration cache.

CUDA graphs exist only on the card, so here ``core/cuda_graph.Graphed`` is
replaced by a stand-in whose replay runs the captured function eagerly over
the same static inputs: the store's bookkeeping runs as on the card, and a
"replayed" registration gives the eager run's bits. The card's own cases
are in tests/test_torch_cuda_kernels.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu_torch.backend import slam
from rivslam_tpu_torch.core import cuda_graph
from rivslam_tpu_torch.core.config import BackendConfig, ImuConfig, LoopConfig, RegistrationConfig
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.eval.timing import StageTimers
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.frontend import apdgicp, apdgicp_fast
from rivslam_tpu_torch.io import synthetic
from rivslam_tpu_torch.loop import detector
from rivslam_tpu_torch.ops import cuda_build

CPU = torch.device("cpu")
CAPACITY = 64
CASES = {
    "fast-K1": dict(use_pallas_correspondence=True),
    "fast-GN": dict(optimizer="GN"),
    "exact-K2": dict(use_fast_path=False),
    "vgicp": dict(method="VGICP"),
}


@pytest.fixture(scope="module")
def clouds():
    """Three consecutive pairs of the bench course at capacity 64."""
    return synthetic.load_pairs(3, CAPACITY, device=CPU)[:4]


def _problem(clouds, cfg, B):
    src_xyz, src_mask, tgt_xyz, tgt_mask = clouds
    src = apdgicp.prepare(src_xyz[:B], src_mask[:B], cfg, device=CPU)
    tgt = apdgicp.prepare(tgt_xyz[:B], tgt_mask[:B], cfg, device=CPU)
    return src, tgt, torch.eye(4).expand(B, 4, 4).contiguous()


class _EagerGraph:
    """``cuda_graph.Graphed`` on the CPU: ``replay`` runs ``fn`` over the
    static inputs eagerly, as a graph would run its kernels."""

    made: list = []

    def __init__(self, name, fn, inputs):
        self.name, self.fn, self.inputs = name, fn, inputs
        self.replays, self.launches = 0, {}
        _EagerGraph.made.append(name)

    def load(self, *values):
        for dst, src in zip(self.inputs, values):
            dst.copy_(src)

    def replay(self):
        self.replays += 1
        return self.fn(*self.inputs)


@pytest.fixture
def eager_graphs(monkeypatch):
    _EagerGraph.made = []
    monkeypatch.setattr(cuda_graph, "Graphed", _EagerGraph)
    return _EagerGraph.made


@pytest.fixture
def tracer():
    t = StageTimers().on()
    try:
        yield t
    finally:
        t.off()


def _assert_same(got, want):
    for field in dataclasses.fields(want):
        assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name


@pytest.mark.parametrize("case", list(CASES))
def test_second_registration_of_a_key_captures_and_later_ones_replay(clouds, eager_graphs, tracer, case):
    """The module store's rule: the first registration of a key runs
    eagerly and captures nothing, the second captures once (the iteration
    and the final step) and replays, the third replays; each gives the eager
    run's bits, and the counters say which path each took."""
    cfg = RegistrationConfig(**CASES[case])
    src, tgt, guess = _problem(clouds, cfg, 2)
    want = apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU)
    store = apdgicp.GraphedRegistration(capture_on=2, shared=True)
    made, replays = [], []
    for _ in range(3):
        with timing.span("caller"):
            got = apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
        _assert_same(got, want)
        made.append(len(eager_graphs))
        replays.append(store.replays)
    assert made == [0, 2, 2]
    assert replays[0] == 0 and replays[2] - replays[1] == replays[1] > 0
    assert len(store.cache.graphs) == 1 and store.cache.seen == {}
    totals = tracer.totals()
    assert totals["registrations_graphed"] == {"caller": 2}
    # one eager run under the span, the other outside any (``want``)
    assert totals["registrations_eager"] == {"caller": 1, timing.OUTSIDE: 1}


def _five_keys(clouds):
    """Five registration keys: three batch sizes of the fast path, two of
    the exact path, one more than ``GraphCache.MAX_KEYS``."""
    keys = [(RegistrationConfig(**CASES["fast-K1"]), B) for B in (1, 2, 3)]
    keys += [(RegistrationConfig(**CASES["exact-K2"]), B) for B in (1, 2)]
    assert len(keys) == cuda_graph.GraphCache.MAX_KEYS + 1
    return keys, [(cfg, _problem(clouds, cfg, B)) for cfg, B in keys]


def test_a_new_key_past_max_keys_evicts_the_oldest(clouds, eager_graphs):
    """Five keys through a cache of 4: the fifth capture drops the oldest
    key's graphs, and that key's next registration runs eagerly again, as a
    first sighting."""
    store = apdgicp.GraphedRegistration(capture_on=2)
    keys, problems = _five_keys(clouds)
    for cfg, (src, tgt, guess) in problems:
        for _ in range(2):
            apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(eager_graphs) == 2 * 5
    assert len(store.cache.graphs) == 4
    held = {(k[1], k[3][0]) for k in store.cache.graphs}
    assert (keys[0][0], 1) not in held and (keys[1][0], 2) in held
    cfg, (src, tgt, guess) = problems[0]
    apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(eager_graphs) == 10  # eager again: no capture
    apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(eager_graphs) == 12 and len(store.cache.graphs) == 4


def test_keys_seen_once_are_bounded_too(clouds, eager_graphs):
    """The keys counted but not yet captured are held to ``MAX_KEYS``, the
    oldest dropped: a key seen once, then pushed out by four newer ones,
    starts over."""
    store = apdgicp.GraphedRegistration(capture_on=2)
    _, problems = _five_keys(clouds)
    for cfg, (src, tgt, guess) in problems:
        apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(store.cache.seen) == 4 and not eager_graphs
    cfg, (src, tgt, guess) = problems[0]
    apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert not eager_graphs  # fast B=1 was dropped: this is its first sighting again
    apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(eager_graphs) == 2


def test_the_loop_worker_defers_its_capture(clouds, eager_graphs, tracer):
    """On the loop worker's thread a capture that falls due is not made:
    the registration runs eagerly and keeps its inputs; ``capture_deferred``
    on another thread captures it, and the worker replays from then on,
    the eager run's bits each time."""
    cfg = RegistrationConfig(**CASES["fast-K1"])
    src, tgt, guess = _problem(clouds, cfg, 3)
    want = apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU)
    store = apdgicp.GraphedRegistration(capture_on=2, shared=True)
    got = []
    with cuda_build.counting_as_worker():
        for _ in range(3):
            got.append(apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store))
    assert not eager_graphs and len(store.cache.deferred) == 1 and store.replays == 0
    assert store.capture_deferred() == 1 and len(eager_graphs) == 2
    assert store.cache.deferred == {} and store.cache.seen == {} and store.capture_deferred() == 0
    with cuda_build.counting_as_worker():
        got.append(apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store))
    assert len(eager_graphs) == 2 and store.replays > 0
    for g in got:
        _assert_same(g, want)
    assert tracer.totals()["registrations_graphed"] == {timing.OUTSIDE: 1}
    assert tracer.totals()["registrations_eager"] == {timing.OUTSIDE: 4}


def test_a_store_that_captures_on_first_use(clouds, eager_graphs, tracer):
    """``capture_on=1`` (the Engine's odometry graphs): the first
    registration captures and replays."""
    cfg = RegistrationConfig(**CASES["fast-K1"])
    src, tgt, guess = _problem(clouds, cfg, 1)
    store = apdgicp.GraphedRegistration()
    apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU, graphs=store)
    assert len(eager_graphs) == 2 and store.replays > 0
    assert tracer.totals()["registrations_graphed"] == {timing.OUTSIDE: 1}
    assert tracer.totals()["registrations_eager"] == {}


@pytest.mark.parametrize("case", list(CASES))
def test_the_cpu_path_is_eager_and_makes_no_store(clouds, monkeypatch, tracer, case):
    """On CPU tensors ``register_dispatch`` and ``prepare_and_register``
    make no module store and run eagerly: one ``registrations_eager`` under
    the span open around each call, no ``registrations_graphed``."""
    monkeypatch.setattr(apdgicp, "_graphs", None)
    cfg = RegistrationConfig(**CASES[case])
    src, tgt, guess = _problem(clouds, cfg, 2)
    with timing.span("scan_match"):
        apdgicp.register_dispatch(src, tgt, guess, cfg, device=CPU)
    src_xyz, src_mask, tgt_xyz, tgt_mask = clouds
    with timing.span("verify"):
        apdgicp.prepare_and_register(src_xyz[0], src_mask[0], tgt_xyz[0], tgt_mask[0], torch.eye(4), cfg,
                                     device=CPU)
    assert apdgicp._graphs is None
    totals = tracer.totals()
    assert totals["registrations_eager"] == {"scan_match": 1, "verify": 1}
    assert totals["registrations_graphed"] == {}


def test_loop_verification_counts_its_registration(clouds, tracer):
    """``detector.verify_loops_batch`` registers its B candidates as one
    registration, counted under the span around it."""
    cfg = RegistrationConfig(**CASES["fast-K1"])
    src_xyz, src_mask, tgt_xyz, tgt_mask = clouds
    with timing.span("engine.loop_detection"):
        res, ok, best = detector.verify_loops_batch(
            src_xyz[0], src_mask[0], tgt_xyz, tgt_mask, torch.zeros(3), torch.ones(3, dtype=torch.bool),
            cfg, LoopConfig())
    assert res.T.shape == (3, 4, 4) and ok.shape == (3,)
    assert tracer.totals()["registrations_eager"] == {"engine.loop_detection": 1}


def test_a_group_registration_stays_eager_and_counts(clouds, tracer):
    """``run_registration`` handed no graphs is eager and counts as such,
    whoever calls it (the distributed layer calls it directly)."""
    cfg = RegistrationConfig(**CASES["fast-K1"])
    src, tgt, guess = _problem(clouds, cfg, 1)
    with pytest.raises(ValueError, match="runs eagerly"):
        apdgicp.run_registration(apdgicp_fast.fast_model, apdgicp_fast.fast_problem(src, tgt), guess, cfg,
                                 apdgicp.GraphedRegistration(), group=object())
    apdgicp.run_registration(apdgicp_fast.fast_model, apdgicp_fast.fast_problem(src, tgt), guess, cfg)
    assert tracer.totals()["registrations_eager"] == {timing.OUTSIDE: 1}


def _imu_buffers(K, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=K) < 0.8
    mask[K - 3:] = False
    return [torch.as_tensor(rng.uniform(0.004, 0.006, K), dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(K, 3)) * 0.3 + [0, 0, 9.8], dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(K, 3)) * 0.2, dtype=torch.float32), torch.as_tensor(mask),
            *(torch.as_tensor(rng.normal(size=3) * 0.01, dtype=torch.float32) for _ in range(2))]


def test_backend_preintegration_captures_one_graph_per_buffer_length(eager_graphs, tracer):
    """``BackendGraphs.preintegrate``: a buffer length's graph is captured on
    its first sight and replayed for every later buffer of that length, bit
    for bit what ``pre.preintegrate`` gives (the CPU twin of the card's
    ``test_graphed_preintegration_equals_eager``)."""
    imu = ImuConfig()
    graphs = slam.BackendGraphs(BackendConfig(), imu, torch.float32, CPU)
    for frame, K in enumerate((40, 40, 20, 40, 20)):
        args = _imu_buffers(K, frame)
        graph = graphs.preintegrate.get(K, K)
        graph.load(*args)
        got = pre.Preintegration(*graph.replay())
        want = pre.preintegrate(*args, imu.gyr_noise, imu.acc_noise)
        for a, b in zip(got.astuple(), want.astuple()):
            assert torch.equal(a, b)
    assert eager_graphs == ["preintegrate[40]", "preintegrate[20]"]
    assert sorted(graphs.preintegrate.graphs) == [20, 40] and graphs.preintegrate.replays == 5


def test_a_capture_due_on_the_worker_is_deferred_for_any_piece():
    """A ``GraphCache`` whose capture is not a registration: a capture that
    falls due inside ``counting_as_worker`` is not made and keeps copies of
    the tensor arguments; ``capture_deferred`` on another thread makes it,
    with the values the worker saw, and the key is then held."""
    made = []
    cache = cuda_graph.GraphCache(lambda n, t: made.append((n, t)) or ("graph", n), capture_on=2)
    t = torch.arange(3.0)
    assert cache.get("k", 3, t) is None and cache.seen == {"k": 1}
    with cuda_build.counting_as_worker():
        assert cache.get("k", 3, t) is None
    t.add_(1.0)  # the kept copy is the worker's
    assert made == [] and list(cache.deferred) == ["k"]
    assert cache.capture_deferred() == 1 and cache.capture_deferred() == 0
    assert made[0][0] == 3 and torch.equal(made[0][1], torch.arange(3.0))
    assert cache.get("k") == ("graph", 3) and cache.seen == {} and cache.deferred == {}
