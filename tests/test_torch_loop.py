"""The port's keyframe-graph and loop-closure modules against the JAX package
on the CPU, on small synthetic inputs made with numpy, in float64: scan
context, the detector's gates and verification, the PCG and block-Schur
global solves, graph and descriptor compaction, the graph's edge Jacobians,
the GPS/barometer residual priors, ``pointcloud.compact`` and the numpy
copies (``io/geo.py``, ``eval/timing.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core import pointcloud as ref_pc
from rivslam_tpu.core.config import LoopConfig as RefLoopConfig
from rivslam_tpu.core.config import RegistrationConfig as RefRegConfig
from rivslam_tpu.eval import timing as ref_timing
from rivslam_tpu.factors import residuals as ref_res
from rivslam_tpu.io import geo as ref_geo
from rivslam_tpu.loop import block_schur as ref_bs
from rivslam_tpu.loop import detector as ref_det
from rivslam_tpu.loop import global_graph as ref_gg
from rivslam_tpu.loop import scancontext as ref_sc
from rivslam_tpu_torch.core import lie, pointcloud
from rivslam_tpu_torch.core.config import LoopConfig, RegistrationConfig
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.factors import residuals
from rivslam_tpu_torch.io import geo, synthetic
from rivslam_tpu_torch.loop import block_schur, detector, global_graph, scancontext

POSE_ATOL = 1e-6  # graph solves in float64: the same arithmetic in another order
F64 = torch.float64


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the numpy copies --------------------------------------------------------


def test_geo_copy_matches_reference():
    rng = np.random.default_rng(0)
    lat = rng.uniform(-80, 84, size=200)
    lon = rng.uniform(-180, 180, size=200)
    alt = rng.normal(size=200) * 50
    lat[:4], lon[:4] = [60.0, 75.0, 1.3521, -33.9], [5.0, 20.0, 103.8198, 151.2]
    np.testing.assert_array_equal(geo.utm_zone(lat, lon), ref_geo.utm_zone(lat, lon))
    for a, b in zip(geo.latlon_to_utm(lat, lon), ref_geo.latlon_to_utm(lat, lon)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(geo.navsat_to_utm(lat, lon, alt), ref_geo.navsat_to_utm(lat, lon, alt))
    assert geo.latlon_to_utm(1.3521, 103.8198) == ref_geo.latlon_to_utm(1.3521, 103.8198)


def test_timing_copy_matches_reference():
    ours, ref = timing.StageTimers(), ref_timing.StageTimers()
    for name, s in (("a", 0.010), ("b", 0.002), ("a", 0.030)):
        ours.add(name, s)
        ref.add(name, s)
    with ours.time("c"):
        pass
    assert set(ours.summary()) == {"a", "b", "c"}
    del ours.samples["c"]
    assert ours.summary() == ref.summary() and ours.report() == ref.report()


# ---- small pieces ------------------------------------------------------------


def test_priors_match_reference():
    rng = np.random.default_rng(1)
    R, R0 = (np.asarray(ref_lie.so3_exp(jnp.asarray(rng.normal(size=3)))) for _ in range(2))
    p, v, bg, ba, p0, v0, bg0, ba0, vdir, vm = (rng.normal(size=3) for _ in range(10))
    cases = [
        (residuals.prior_xy, ref_res.prior_xy, (p, p[:2] + 0.1)),
        (residuals.prior_xyz, ref_res.prior_xyz, (p, p0)),
        (residuals.prior_z, ref_res.prior_z, (p, p0[2:3])),
        (residuals.prior_quat, ref_res.prior_quat, (R, R0)),
        (residuals.prior_vec, ref_res.prior_vec, (R, vdir, vm)),
        (residuals.prior_navstate, ref_res.prior_navstate, (R, p, v, bg, ba, R0, p0, v0, bg0, ba0)),
    ]
    for ours, ref, args in cases:
        np.testing.assert_allclose(
            _np(ours(*map(_t, args))), np.asarray(ref(*map(jnp.asarray, args))), rtol=0, atol=1e-12,
            err_msg=ours.__name__,
        )


def test_pointcloud_compact_matches_reference():
    rng = np.random.default_rng(2)
    n = 50
    xyz, dop, inten = rng.normal(size=(n, 3)), rng.normal(size=n), rng.uniform(size=n)
    mask = rng.uniform(size=n) > 0.4
    got = pointcloud.compact(pointcloud.RadarCloud(_t(xyz), _t(dop), _t(inten), _t(mask)))
    want = ref_pc.compact(ref_pc.RadarCloud(*map(jnp.asarray, (xyz, dop, inten, mask))))
    for f in ("xyz", "doppler", "intensity", "mask"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)


def test_edge_jacobians_closed_form_match_jacfwd():
    """The closed-form edge Jacobians against torch.func.jacfwd of the
    residual through both retractions (the reference's construction), and
    the reference's jax.jacfwd, to rounding."""
    rng = np.random.default_rng(3)
    E = 12
    Rs = [np.array(ref_lie.so3_exp(jnp.asarray(rng.normal(size=(E, 3)) * s))) for s in (1.0, 1.0, 0.05)]
    Ri, Rj, Rm = Rs
    Rj[:3] = Ri[:3] @ Rm[:3]  # residual rotation ~0: the small-angle branch
    pi, pj, pm = (rng.normal(size=(E, 3)) for _ in range(3))
    args = [_t(a) for a in (Ri, pi, Rj, pj, Rm, pm)]
    r, Ji, Jj = global_graph._edge_res_and_jac(*args)

    def f(di, dj, Ri, pi, Rj, pj, Rm, pm):
        lead = lambda a: a[None]  # noqa: E731  (0-dim duals promote to float64 under jacfwd)
        return global_graph._edge_residual(
            lead(Ri) @ lie.so3_exp(lead(di[:3])), lead(pi + di[3:]),
            lead(Rj) @ lie.so3_exp(lead(dj[:3])), lead(pj + dj[3:]), lead(Rm), lead(pm),
        )[0]

    z = torch.zeros(6, dtype=F64)
    for argnum, J in ((0, Ji), (1, Jj)):
        Jf = torch.func.vmap(torch.func.jacfwd(f, argnums=argnum), in_dims=(None, None) + (0,) * 6)(z, z, *args)
        np.testing.assert_allclose(J.numpy(), Jf.numpy(), rtol=0, atol=1e-10)
    ref = jax.jit(jax.vmap(ref_gg._edge_res_and_jac))(*map(jnp.asarray, (Ri, pi, Rj, pj, Rm, pm)))
    for got, want in zip((r, Ji, Jj), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


# ---- the global graph ----------------------------------------------------------


def _graph_arrays(K=32, L=4, n=30, seed=0):
    """A drifted loop of n keyframes (tests/test_block_schur.py's pattern):
    noisy odometry, two loop edges ((0, n-1) and the interior (5, 21)), GPS
    priors on every 6th node and a barometer-style z-only prior on every
    7th."""
    rng = np.random.default_rng(seed)
    step = np.eye(4)
    step[:3, :3] = np.asarray(ref_lie.so3_exp(jnp.asarray([0.0, 0.0, 2 * np.pi / n])))
    step[0, 3] = 1.0
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    est, rels = [np.eye(4)], [np.eye(4)]
    for k in range(1, n):
        noise = np.asarray(ref_lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01)))
        rels.append(np.linalg.inv(gt[k - 1]) @ gt[k] @ noise)
        est.append(est[-1] @ rels[-1])
    est, rels = np.stack(est), np.stack(rels)
    a = dict(
        R=np.tile(np.eye(3), (K, 1, 1)), p=np.zeros((K, 3)), node_mask=np.arange(K) < n,
        odom_rel_R=np.tile(np.eye(3), (K, 1, 1)), odom_rel_p=np.zeros((K, 3)),
        odom_info=np.tile(np.eye(6), (K, 1, 1)), loop_i=np.zeros(L, np.int64),
        loop_j=np.zeros(L, np.int64), loop_rel_R=np.tile(np.eye(3), (L, 1, 1)),
        loop_rel_p=np.zeros((L, 3)), loop_info=np.tile(np.eye(6), (L, 1, 1)),
        loop_mask=np.zeros(L, bool), anchor_info=np.diag([1.0, 1.0, 1.0, 0.1, 0.1, 0.1]),
        gps_xyz=np.zeros((K, 3)), gps_info=np.ones((K, 3)), gps_mask=np.zeros(K, bool),
    )
    a["R"][:n], a["p"][:n] = est[:, :3, :3], est[:, :3, 3]
    a["odom_rel_R"][:n], a["odom_rel_p"][:n] = rels[:, :3, :3], rels[:, :3, 3]
    a["odom_info"][:n] = np.eye(6) * 100.0 * rng.uniform(0.5, 2.0, size=(n, 1, 1))
    for e, (i, j) in enumerate([(0, n - 1), (5, 21)]):
        rel = np.linalg.inv(gt[i]) @ gt[j]
        a["loop_i"][e], a["loop_j"][e], a["loop_mask"][e] = i, j, True
        a["loop_rel_R"][e], a["loop_rel_p"][e] = rel[:3, :3], rel[:3, 3]
        a["loop_info"][e] = np.eye(6) * 400.0
    for k in range(0, n, 6):
        a["gps_xyz"][k], a["gps_info"][k], a["gps_mask"][k] = gt[k, :3, 3], 25.0, True
    for k in range(3, n, 7):
        a["gps_xyz"][k], a["gps_info"][k], a["gps_mask"][k] = [0, 0, gt[k, 2, 3]], [0, 0, 4.0], True
    return a, n


def _both_graphs(a):
    ours = global_graph.PoseGraph(**{k: _t(v) for k, v in a.items()})
    ref = ref_gg.PoseGraph(**{
        k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in a.items()
    })
    return ours, ref


@pytest.mark.parametrize("solver", ["PCG", "SCHUR"])
def test_global_solve_matches_reference(solver):
    a, n = _graph_arrays()
    ours, ref = _both_graphs(a)
    if solver == "PCG":
        got, chi2 = global_graph.solve_pose_graph(ours, gn_iters=6)
        want, ref_chi2 = ref_gg.solve_pose_graph(ref, gn_iters=6)
    else:
        got, chi2 = block_schur.solve_pose_graph_schur(ours, num_blocks=4, gn_iters=6)
        want, ref_chi2 = ref_bs.solve_pose_graph_schur(ref, num_blocks=4, gn_iters=6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(float(chi2), float(ref_chi2), rtol=1e-6)
    # and it moved: the drifted start is far from the solution
    assert np.abs(got.p.numpy()[:n] - a["p"][:n]).max() > 0.05


def test_schur_pieces_match_reference():
    """One linearization's assembled blocks, and the elimination, equal."""
    a, _ = _graph_arrays()
    ours, ref = _both_graphs(a)
    S, B = 4, 8
    lin = block_schur._linearize_assemble(ours, ours.R, ours.p, S, B, 1.0)
    ref_lin = jax.jit(ref_bs._linearize_assemble, static_argnums=(3, 4, 5))(ref, ref.R, ref.p, S, B, 1.0)
    for key in ("Hb", "gb", "D", "sdim", "g_full", "chi2"):
        np.testing.assert_allclose(_np(lin[key]), np.asarray(ref_lin[key]), rtol=0, atol=1e-8, err_msg=key)
    Pdim = 6 * (2 * S + 2 * 4 + 1)
    got = block_schur._eliminate_local(lin["Hb"], lin["gb"], lin["D"], lin["sdim"], Pdim)
    want = jax.jit(ref_bs._eliminate_local, static_argnums=(4, 5))(
        ref_lin["Hb"], ref_lin["gb"], ref_lin["D"], ref_lin["sdim"], Pdim, jnp.float64)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-9, atol=1e-7)


def test_effective_blocks_matches_reference():
    for cap, req in ((48, 32), (2048, 32), (7, 32), (64, 8), (30, 4)):
        assert block_schur.effective_blocks(cap, req) == ref_bs.effective_blocks(cap, req)


def test_graph_compact_matches_reference():
    a, n = _graph_arrays()
    ours, ref = _both_graphs(a)
    keep = sorted(set(range(0, n, 2)) | {0, 5, 21, n - 1})
    got, m = global_graph.compact(ours, keep, n)
    want, ref_m = ref_gg.compact(ref, keep, n)
    assert m == ref_m
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(_np(getattr(got, f.name)), np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


# ---- scan context ------------------------------------------------------------------


SC_CFG = dict(keyframe_capacity=16, num_exclude_recent=3, num_candidates=3, sc_dist_thresh=0.7)


def _scans(n_kf=12, seed=4, cap=400):
    """Keyframe clouds along a circle through one synthetic world, with
    intensities: the last ones revisit the first ones' places."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(rng, n_points=6000, extent=30.0)
    out = []
    for k in range(n_kf):
        th = 2 * np.pi * (k % 9) / 9
        T = np.eye(4)
        T[:3, :3] = np.asarray(ref_lie.so3_exp(jnp.asarray([0.0, 0.0, th + 0.02 * k])))
        T[:3, 3] = [6 * np.cos(th), 6 * np.sin(th), 0.0]
        cl = synthetic.observe(world, T, rng, capacity=cap, noise=0.01, device="cpu")
        xyz = cl.xyz.double().numpy()
        inten = rng.uniform(0.1, 5.0, size=cap)
        out.append((xyz, inten, cl.mask.numpy()))
    return out


def _both_dbs(scans, n):
    ours = scancontext.ScanContextDB.create(LoopConfig(**SC_CFG), dtype=F64)
    ref = ref_sc.ScanContextDB.create(RefLoopConfig(**SC_CFG), dtype=jnp.float64)
    for xyz, inten, mask in scans[:n]:
        d = scancontext.make_descriptor(_t(xyz), _t(inten), _t(mask), LoopConfig(**SC_CFG))
        ours, dropped = scancontext.insert(ours, d)
        assert not dropped
        ref, _ = ref_sc.insert(ref, ref_sc.make_descriptor(*map(jnp.asarray, (xyz, inten, mask)),
                                                           RefLoopConfig(**SC_CFG)))
    return ours, ref


def test_scancontext_descriptors_and_db_match_reference():
    scans = _scans()
    ours, ref = _both_dbs(scans, 12)
    for f in ("desc", "ring_key", "sector_key", "count"):
        np.testing.assert_allclose(_np(getattr(ours, f)), np.asarray(getattr(ref, f)), rtol=0, atol=1e-12)
    assert float(ours.desc.amax()) > 0
    keep = [0, 2, 3, 7, 11]
    same = ref_sc.ScanContextDB(**{f: jnp.asarray(_np(getattr(ours, f))) for f in ("desc", "ring_key", "sector_key")},
                                count=jnp.asarray(int(ours.count), jnp.int32))
    got, want = scancontext.compact(ours, keep), ref_sc.compact(same, keep)
    for f in ("desc", "ring_key", "sector_key", "count"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("query", [9, 10, 11])
def test_scancontext_match_and_topk_match_reference(query):
    scans = _scans()
    ours, ref = _both_dbs(scans, query + 1)
    xyz, inten, mask = scans[query]
    cfg, rcfg = LoopConfig(**SC_CFG), RefLoopConfig(**SC_CFG)
    cand = np.ones(16, bool)
    cand[1] = False
    d = scancontext.make_descriptor(_t(xyz), _t(inten), _t(mask), cfg)
    rd = ref_sc.make_descriptor(*map(jnp.asarray, (xyz, inten, mask)), rcfg)
    got = scancontext.match(ours, d, query, _t(cand), cfg)
    want = ref_sc.match(ref, rd, jnp.asarray(query), jnp.asarray(cand), rcfg)
    assert int(got[0]) == int(want[0])
    np.testing.assert_allclose([float(x) for x in got[1:]], [float(x) for x in want[1:]], rtol=0, atol=1e-12)
    got = scancontext.match_topk(ours, d, query, _t(cand), cfg, 3)
    want = ref_sc.match_topk(ref, rd, jnp.asarray(query), jnp.asarray(cand), rcfg, 3)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_).astype(np.float64), np.asarray(w_).astype(np.float64),
                                   rtol=0, atol=1e-12)
    if query == 9:  # keyframe 9 revisits keyframe 0's place
        assert int(got[0][0]) == 0 and bool(got[3][0])


# ---- detector --------------------------------------------------------------------


def test_prefilter_matches_reference():
    a, n = _graph_arrays(K=32, n=30)
    rng = np.random.default_rng(5)
    accum = np.zeros(32)
    accum[:n] = np.cumsum(rng.uniform(0.5, 1.5, size=n))
    alt = rng.normal(size=32) * 2
    alt_valid = rng.uniform(size=32) > 0.3
    seen = []
    for k, last, cfg_kw in ((29, 0.0, {}), (29, 10.0, dict(accum_distance_thresh=15.0)),
                            (20, 3.0, dict(accum_distance_thresh=5.0, odom_drift_xy=0.2))):
        cfg = dict(min_loop_interval_dist=2.0, max_yaw_difference_deg=40.0, **cfg_kw)
        got = detector.prefilter_candidates(
            _t(accum), _t(a["R"]), _t(a["p"]), _t(a["node_mask"]), k, last, LoopConfig(**cfg),
            altitude=_t(alt), altitude_valid=_t(alt_valid),
        )
        want = ref_det.prefilter_candidates(
            jnp.asarray(accum), jnp.asarray(a["R"]), jnp.asarray(a["p"]), jnp.asarray(a["node_mask"]),
            jnp.asarray(k), jnp.asarray(last), RefLoopConfig(**cfg),
            altitude=jnp.asarray(alt), altitude_valid=jnp.asarray(alt_valid),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seen.append(int(got.sum()))
    assert 0 < max(seen) < 32 and min(seen) == 0


def _pose(rng, rot=0.3, trans=3.0):
    return np.asarray(ref_lie.se3_exp(jnp.asarray(np.concatenate([rng.normal(size=3) * rot,
                                                                  rng.normal(size=3) * trans]))))


def test_odometry_and_pairwise_checks_match_reference():
    rng = np.random.default_rng(6)
    cfg, rcfg = LoopConfig(), RefLoopConfig()
    outcomes = set()
    for trial in range(24):
        odom_i, odom_j, prev_old, prev_new = (_pose(rng) for _ in range(4))
        consistent = np.linalg.inv(odom_j) @ odom_i  # T(j<-i) that agrees with odometry
        noise = _pose(rng, rot=0.02 * (trial % 4), trans=0.15 * (trial % 4))
        T_lc = noise @ np.linalg.inv(consistent)
        T_prev = np.linalg.inv(prev_old) @ prev_new @ _pose(rng, rot=0.01 * (trial % 3), trans=0.5 * (trial % 3))
        nb = 1 + trial % 5
        got = bool(detector.odometry_check(_t(T_lc), _t(odom_i), _t(odom_j), nb, cfg))
        want = bool(ref_det.odometry_check(*map(jnp.asarray, (T_lc, odom_i, odom_j)), jnp.asarray(nb), rcfg))
        assert got == want
        args = (T_lc, odom_i, odom_j, prev_old, prev_new, T_prev)
        for have in (True, False):
            got_p = bool(detector.pairwise_check(*map(_t, args), have, cfg))
            want_p = bool(ref_det.pairwise_check(*map(jnp.asarray, args), jnp.asarray(have), rcfg))
            assert got_p == want_p
        outcomes.add((got, got_p))
    assert len(outcomes) >= 2  # both gates see passing and failing inputs


def test_verify_loops_batch_matches_reference():
    """Verification of 3 candidates, seeded with the scan-context yaw,
    through the exact registration (the fast one has its own parity tests,
    tests/test_torch_apdgicp.py)."""
    scans = _scans(cap=256)
    new_xyz, _, new_mask = scans[9]
    cands = [scans[i] for i in (0, 4, 8)]
    cand_xyz = np.stack([c[0] for c in cands])
    cand_mask = np.stack([c[2] for c in cands])
    yaws, valid = np.array([0.18, 0.1, 0.0]), np.array([True, True, False])
    cfg, rcfg = LoopConfig(use_sc_yaw_guess=True), RefLoopConfig(use_sc_yaw_guess=True)
    reg, rreg = RegistrationConfig(use_fast_path=False), RefRegConfig(use_fast_path=False)
    res, ok, best = detector.verify_loops_batch(
        *map(_t, (new_xyz, new_mask, cand_xyz, cand_mask, yaws, valid)), reg, cfg
    )
    rres, rok, rbest = jax.jit(lambda *a: ref_det.verify_loops_batch(*a, rreg, rcfg))(
        *map(jnp.asarray, (new_xyz, new_mask, cand_xyz, cand_mask, yaws, valid))
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert int(best) == int(rbest) and bool(ok[0])
    np.testing.assert_allclose(res.T.numpy(), np.asarray(rres.T), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res.num_correspondences.numpy(), np.asarray(rres.num_correspondences))


# ---- every preset as shipped -------------------------------------------------------


PRESETS = ["cp", "garden", "hugin", "long", "mine", "ntu4dradlm", "nyl", "sjtu"]


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_runs_as_shipped(name):
    """The Engine takes each preset unmodified (loop closure on; scan-to-map
    odometry on for nyl and garden) and runs a few frames on the CPU at
    small capacity."""
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.frontend import scan2map
    from rivslam_tpu_torch.io import datasets

    assert presets.names() == PRESETS  # every preset is one case here
    cfg = presets.get(name)
    assert cfg.loop.enable and not cfg.loop.async_loop
    assert cfg.odometry.enable_scan_to_map == (name in ("nyl", "garden"))
    seq, _ = synthetic.simulate_sequence(seed=3, n_frames=2, capacity=128, world_points=4000,
                                         extent=30.0)
    eng = pipeline.Engine(cfg, device="cpu")
    outs = datasets.replay(eng, seq, 128, 32)
    assert all(np.isfinite(o["pose"]).all() for o in outs)
    assert eng.state.kf_count == sum(o["is_keyframe"] for o in outs) >= 1
    assert eng.trajectory()[1].shape == (2, 4, 4)
    assert isinstance(eng.state.odo, scan2map.SubmapOdometryState) == cfg.odometry.enable_scan_to_map
