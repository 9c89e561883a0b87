"""PyTorch port point ops against the JAX package on the CPU: PLANE
regularization, nearest-neighbour search, and the plain twins of K1, K2 and
K3 against the Pallas kernels run in interpret mode (mirroring
tests/test_pallas_nn.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu.ops import eig3 as ref_eig3
from rivslam_tpu.ops import knn as ref_knn
from rivslam_tpu.ops import pallas_nn
from rivslam_tpu.core.pointcloud import RadarCloud as RefCloud
from rivslam_tpu.core.pointcloud import masked_xyz as ref_masked_xyz
from rivslam_tpu_torch.ops import cuda_build, eig3, knn, nn_argmin, nn_corr, nn_gather

# d2 tolerances of tests/test_pallas_nn.py: the interpreted kernel's cross
# term is an XLA dot, the twin's three separately rounded products; features
# of a unique winner are copied exactly.
D2_RTOL, D2_ATOL, G_TOL = 1e-4, 1e-3, 1e-5


def _covariances(kind, n=300):
    """float64: random PSD 3x3s (as tests/test_eig3.py) plus the degenerate
    zero, isotropic and rank-2 planar matrices that take the fallback
    branches; float32: the disc-shaped covariances a scan produces
    (eigenvalues 1, 0.5 and 1e-3 in random orientations)."""
    rng = np.random.default_rng(0)
    if kind == "psd64":
        A = rng.normal(size=(n, 3, 3))
        C = A @ np.swapaxes(A, 1, 2)
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        C[0], C[1], C[2] = 0.0, 2.0 * np.eye(3), Q @ np.diag([4.0, 4.0, 0.0]) @ Q.T
        return C
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return (Q @ (np.array([1.0, 0.5, 1e-3])[:, None] * np.swapaxes(Q, 1, 2))).astype(np.float32)


# the same closed-form formulas in two libraries: float64 agrees to rounding;
# float32 to the rounding of arccos/cos and the cross products at |C| ~ 1
@pytest.mark.parametrize("kind,atol", [("psd64", 1e-9), ("disc32", 1e-5)])
def test_plane_regularize_soa_matches_reference(kind, atol):
    C = _covariances(kind)
    comps = [C[:, 0, 0], C[:, 0, 1], C[:, 0, 2], C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]]
    want = ref_eig3.plane_regularize_soa(*map(jnp.asarray, comps), 1e-3)
    got = eig3.plane_regularize_soa(*map(torch.as_tensor, comps), 1e-3)
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(C).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


def test_pairwise_and_nearest_neighbor_match_reference():
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(2, 300, 3)) * 10).astype(np.float32)
    r = (rng.normal(size=(2, 700, 3)) * 10).astype(np.float32)
    mask = rng.uniform(size=(2, 700)) > 0.2
    want = np.asarray(ref_knn.pairwise_sqdist(jnp.asarray(q), jnp.asarray(r)))
    got = knn.pairwise_sqdist(torch.as_tensor(q), torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    idx_w, d2_w = ref_knn.nearest_neighbor(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask))
    idx, d2 = knn.nearest_neighbor(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(mask))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_w), rtol=1e-5, atol=1e-3)


# ---- K1's plain twin vs fused_gather_pallas(interpret=True) ----------------


def _k1_pair(q, r, mask, feats):
    """Per problem, the interpreted Pallas kernel; batched, the port's twin."""
    want = [
        pallas_nn.fused_gather_pallas(
            jnp.asarray(q[b]), jnp.asarray(r[b]), jnp.asarray(mask[b]),
            jnp.asarray(feats[b]), interpret=True,
        )
        for b in range(q.shape[0])
    ]
    d2, g = nn_gather.fused_gather(*map(torch.as_tensor, (q, r, mask, feats)))
    return d2.numpy(), g.numpy(), np.stack([np.asarray(w[0]) for w in want]), \
        np.stack([np.asarray(w[1]) for w in want])


def _cloud(rng, shape, scale=10.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "n,m",
    [(300, 700), (97, 513), (200, 1500)],  # as test_pallas_nn; ragged; two TPU tiles
)
def test_fused_gather_plain_matches_pallas(n, m):
    rng = np.random.default_rng(n + m)
    q, r = _cloud(rng, (2, n, 3)), _cloud(rng, (2, m, 3))
    mask = rng.uniform(size=(2, m)) > 0.15
    feats = rng.normal(size=(2, 9, m)).astype(np.float32)
    d2, g, d2_w, g_w = _k1_pair(q, r, mask, feats)
    np.testing.assert_allclose(d2, d2_w, rtol=D2_RTOL, atol=D2_ATOL)
    np.testing.assert_allclose(g, g_w, rtol=G_TOL, atol=G_TOL)
    # and against argmin + fancy-index gather in float64
    D = ((q[:, :, None, :].astype(np.float64) - r[:, None, :, :]) ** 2).sum(-1)
    D[~np.broadcast_to(mask[:, None, :], D.shape)] = np.inf
    idx = D.argmin(-1)
    np.testing.assert_allclose(d2, D.min(-1), rtol=D2_RTOL, atol=D2_ATOL)
    np.testing.assert_allclose(g, np.stack([feats[b][:, idx[b]] for b in range(2)]), atol=G_TOL)


def test_fused_gather_plain_ties_average():
    """Exact ties are averaged, within a tile and across the 1024-target tiles."""
    q = np.zeros((1, 2, 3), np.float32)
    q[0, 1] = [5.0, 5.0, 5.0]
    r = np.full((1, 1100, 3), 50.0, np.float32)
    r[0, 0] = [1.0, 0.0, 0.0]
    r[0, 1] = [-1.0, 0.0, 0.0]
    r[0, 1050] = [0.0, 1.0, 0.0]  # third tie, in the second tile
    r[0, 7] = r[0, 1090] = [5.0, 5.0, 5.0]  # query 1 sits on a duplicated point
    feats = np.zeros((1, 1, 1100), np.float32)
    feats[0, 0, [0, 1, 1050, 7, 1090]] = [10.0, 20.0, 60.0, 3.0, 5.0]
    d2, g, d2_w, g_w = _k1_pair(q, r, np.ones((1, 1100), bool), feats)
    np.testing.assert_allclose(d2[0, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(g[0, 0], [30.0, 4.0], atol=G_TOL)
    np.testing.assert_allclose(g, g_w, atol=G_TOL)
    np.testing.assert_allclose(d2, d2_w, rtol=D2_RTOL, atol=D2_ATOL)


def test_fused_gather_plain_all_masked():
    rng = np.random.default_rng(9)
    q, r = _cloud(rng, (2, 64, 3), 1.0), _cloud(rng, (2, 128, 3), 1.0)
    mask = np.zeros((2, 128), bool)
    mask[1, ::3] = True  # problem 1 keeps a third of its targets
    feats = rng.normal(size=(2, 5, 128)).astype(np.float32)
    d2, g, d2_w, g_w = _k1_pair(q, r, mask, feats)
    assert (d2[0] > 1e29).all() and (d2_w[0] > 1e29).all()
    np.testing.assert_array_equal(g[0], 0.0)
    np.testing.assert_allclose(g[1], g_w[1], atol=G_TOL)


def test_fused_gather_on_cpu_uses_the_twin_and_counts_no_launch():
    rng = np.random.default_rng(4)
    args = [torch.as_tensor(a) for a in (
        _cloud(rng, (3, 50, 3)), _cloud(rng, (3, 80, 3)),
        rng.uniform(size=(3, 80)) > 0.3, rng.normal(size=(3, 9, 80)).astype(np.float32),
    )]
    before = nn_gather.fused_gather.launches
    d2, g = nn_gather.fused_gather(*args)
    d2_p, g_p = nn_gather.fused_gather_plain(*args)
    assert nn_gather.fused_gather.launches == before
    assert torch.equal(d2, d2_p) and torch.equal(g, g_p)
    assert d2.shape == (3, 50) and g.shape == (3, 9, 50)


@pytest.mark.parametrize(
    "bad",
    ["query_shape", "ref_batch", "mask_dtype", "feats_m"],
)
def test_fused_gather_rejects_bad_inputs(bad):
    q, r = torch.zeros(2, 10, 3), torch.zeros(2, 20, 3)
    m, f = torch.ones(2, 20, dtype=torch.bool), torch.zeros(2, 9, 20)
    if bad == "query_shape":
        q = torch.zeros(2, 10, 4)
    elif bad == "ref_batch":
        r = torch.zeros(3, 20, 3)
    elif bad == "mask_dtype":
        m = m.float()
    else:
        f = torch.zeros(2, 9, 21)
    with pytest.raises(ValueError):
        nn_gather.fused_gather(q, r, m, f)


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    """A changed source gets a new build key, so a stale library is never loaded."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(nn_gather, "SOURCE", str(src))
    p1 = nn_gather.library_path()
    src.write_text("// v2\n")
    assert nn_gather.library_path() != p1
    assert p1.startswith(nn_gather.BUILD_DIR) and p1.endswith(".so")


# ---- K3's plain twin vs nearest_neighbor_pallas(interpret=True) -------------
# (tests/test_pallas_nn.py:11-41: idx equal, d2 within rtol 1e-4 / atol 1e-3;
# the interpreted kernel's cross term is an XLA dot, the twin's three
# separately rounded products)


def _k3_vs_reference(q, r, capacity):
    """One problem: the interpreted Pallas kernel, the XLA knn path and the
    port's twin, on a cloud padded to ``capacity`` like the reference test."""
    cloud = RefCloud.from_numpy(r, capacity, dtype=jnp.float32)
    ref_idx, ref_d2 = ref_knn.nearest_neighbor(jnp.asarray(q), ref_masked_xyz(cloud), cloud.mask)
    pal_idx, pal_d2 = pallas_nn.nearest_neighbor_pallas(
        jnp.asarray(q), cloud.xyz, cloud.mask, interpret=True
    )
    idx, d2 = nn_argmin.nearest_neighbor(
        torch.as_tensor(q)[None], torch.tensor(np.asarray(cloud.xyz))[None],
        torch.tensor(np.asarray(cloud.mask))[None],
    )
    return idx[0].numpy(), d2[0].numpy(), (ref_idx, ref_d2), (pal_idx, pal_d2)


@pytest.mark.parametrize("n,m,capacity", [(300, 700, 1024), (97, 513, 513)], ids=["padded", "unaligned"])
def test_nearest_neighbor_plain_matches_pallas_and_knn(n, m, capacity):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, 3)).astype(np.float32) * 10
    r = rng.normal(size=(m, 3)).astype(np.float32) * 10
    idx, d2, (ref_idx, ref_d2), (pal_idx, pal_d2) = _k3_vs_reference(q, r, capacity)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, np.asarray(pal_idx))
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(d2, np.asarray(pal_d2), rtol=D2_RTOL, atol=D2_ATOL)
    np.testing.assert_allclose(d2, np.asarray(ref_d2), rtol=D2_RTOL, atol=D2_ATOL)


def test_nearest_neighbor_plain_all_masked():
    """No valid ref: d2 1e30 and idx 0, as the TPU kernel gives."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 64, 3)).astype(np.float32)
    r = rng.normal(size=(2, 128, 3)).astype(np.float32)
    mask = np.zeros((2, 128), bool)
    mask[1, 5::7] = True
    idx, d2 = nn_argmin.nearest_neighbor(*map(torch.as_tensor, (q, r, mask)))
    pal_idx, pal_d2 = pallas_nn.nearest_neighbor_pallas(
        jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.zeros(128, dtype=bool), interpret=True
    )
    assert (d2[0].numpy() > 1e29).all() and (np.asarray(pal_d2) > 1e29).all()
    np.testing.assert_array_equal(idx[0].numpy(), 0)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(pal_idx))
    assert mask[1, idx[1].numpy()].all()


def test_nearest_neighbor_plain_first_index_wins_ties():
    """Exact duplicates within a 512-ref tile and across the tile edge: the
    first index wins, as in the TPU kernel (strict update across tiles)."""
    r = np.full((1, 1100, 3), 50.0, np.float32)
    r[0, :5] = np.arange(15, dtype=np.float32).reshape(5, 3)
    r[0, 300] = r[0, 1]  # tie inside the first tile
    r[0, 600] = r[0, 2]  # tie across the tile edge
    r[0, 1050] = r[0, 3]
    q = r[:, :5].copy()
    mask = np.ones((1, 1100), bool)
    mask[0, 4] = False  # query 4's exact match is masked: its twin never wins
    idx, d2 = nn_argmin.nearest_neighbor(*map(torch.as_tensor, (q, r, mask)))
    pal_idx, _ = pallas_nn.nearest_neighbor_pallas(
        jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(mask[0]), interpret=True
    )
    np.testing.assert_array_equal(idx[0].numpy()[:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(pal_idx))
    assert idx[0, 4].item() != 4


def test_nearest_neighbor_on_cpu_uses_the_twin_and_counts_no_launch():
    rng = np.random.default_rng(4)
    args = [torch.as_tensor(a) for a in (
        _cloud(rng, (3, 50, 3)), _cloud(rng, (3, 600, 3)), rng.uniform(size=(3, 600)) > 0.3,
    )]
    before = nn_argmin.nearest_neighbor.launches
    idx, d2 = nn_argmin.nearest_neighbor(*args)
    idx_p, d2_p = nn_argmin.nearest_neighbor_plain(*args)
    assert nn_argmin.nearest_neighbor.launches == before
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert idx.shape == (3, 50) and d2.shape == (3, 50)


@pytest.mark.parametrize("bad", ["query_shape", "ref_batch", "mask_dtype", "mask_m"])
def test_nearest_neighbor_rejects_bad_inputs(bad):
    q, r, m = torch.zeros(2, 10, 3), torch.zeros(2, 20, 3), torch.ones(2, 20, dtype=torch.bool)
    if bad == "query_shape":
        q = torch.zeros(2, 10, 4)
    elif bad == "ref_batch":
        r = torch.zeros(3, 20, 3)
    elif bad == "mask_dtype":
        m = m.float()
    else:
        m = torch.ones(2, 21, dtype=torch.bool)
    with pytest.raises(ValueError):
        nn_argmin.nearest_neighbor(q, r, m)


# ---- K2's plain twin vs fused_correspondence_pallas(interpret=True) ---------
# (tests/test_pallas_nn.py:44-60: idx equal, d2 within rtol 1e-4 / atol 1e-3,
# the gathered rows equal)


def _k2_pallas(q, r, mask, feats):
    """The interpreted TPU kernel, one problem at a time."""
    outs = [
        pallas_nn.fused_correspondence_pallas(
            jnp.asarray(q[b]), jnp.asarray(r[b]), jnp.asarray(mask[b]), jnp.asarray(feats[b]),
            interpret=True,
        )
        for b in range(len(q))
    ]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(3)]


def _k2_case(case):
    rng = np.random.default_rng(11)
    if case == "contract":  # tests/test_pallas_nn.py:44-60's inputs
        shape, F, masked = (1, 300, 700), 9, 0.15
    elif case == "batched":
        shape, F, masked = (3, 256, 512), 12, 0.2
    elif case == "ragged":
        shape, F, masked = (2, 97, 1100), 5, 0.3
    else:  # F at its bounds
        shape, F, masked = (2, 64, 600), {"F1": 1, "F128": 128}[case], 0.1
    B, n, m = shape
    q = rng.normal(size=(B, n, 3)).astype(np.float32) * 10
    r = rng.normal(size=(B, m, 3)).astype(np.float32) * 10
    mask = rng.uniform(size=(B, m)) > masked
    feats = rng.normal(size=(B, m, F)).astype(np.float32)
    return q, r, mask, feats


@pytest.mark.parametrize("case", ["contract", "batched", "ragged", "F1", "F128"])
def test_fused_correspondence_plain_matches_pallas(case):
    q, r, mask, feats = _k2_case(case)
    idx, d2, g = (t.numpy() for t in nn_corr.fused_correspondence(*map(torch.as_tensor, (q, r, mask, feats))))
    pal_idx, pal_d2, pal_g = _k2_pallas(q, r, mask, feats)
    assert idx.dtype == np.int32 and g.shape == feats.shape[:1] + q.shape[1:2] + feats.shape[2:]
    np.testing.assert_array_equal(idx, pal_idx)
    np.testing.assert_allclose(d2, pal_d2, rtol=D2_RTOL, atol=D2_ATOL)
    np.testing.assert_array_equal(g, pal_g)
    np.testing.assert_array_equal(g, np.take_along_axis(feats, idx[..., None].astype(np.int64), 1))


def test_fused_correspondence_plain_all_masked():
    """No valid ref: idx 0, d2 1e30 and zero features, as the TPU kernel."""
    q, r, mask, feats = _k2_case("batched")
    mask[0] = False
    idx, d2, g = nn_corr.fused_correspondence(*map(torch.as_tensor, (q, r, mask, feats)))
    pal_idx, pal_d2, pal_g = _k2_pallas(q[:1], r[:1], mask[:1], feats[:1])
    assert (d2[0].numpy() > 1e29).all() and (pal_d2 > 1e29).all()
    np.testing.assert_array_equal(idx[0].numpy(), 0)
    np.testing.assert_array_equal(idx[0].numpy(), pal_idx[0])
    np.testing.assert_array_equal(g[0].numpy(), 0.0)
    np.testing.assert_array_equal(pal_g[0], 0.0)
    assert mask[1, idx[1].numpy()].all()


def test_fused_correspondence_plain_first_index_wins_ties():
    """Exact duplicates within a 512-ref tile and across the tile edge: the
    first index and its row win, as in the TPU kernel."""
    r = np.full((1, 1100, 3), 50.0, np.float32)
    r[0, :5] = np.arange(15, dtype=np.float32).reshape(5, 3)
    r[0, 300], r[0, 600], r[0, 1050] = r[0, 1], r[0, 2], r[0, 3]
    q = r[:, :5].copy()
    mask = np.ones((1, 1100), bool)
    mask[0, 4] = False
    feats = np.arange(1100 * 3, dtype=np.float32).reshape(1, 1100, 3)
    idx, _, g = nn_corr.fused_correspondence(*map(torch.as_tensor, (q, r, mask, feats)))
    pal_idx, _, pal_g = _k2_pallas(q, r, mask, feats)
    np.testing.assert_array_equal(idx[0].numpy()[:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(idx.numpy(), pal_idx)
    np.testing.assert_array_equal(g.numpy(), pal_g)


def test_fused_correspondence_on_cpu_uses_the_twin_and_counts_no_launch():
    args = [torch.as_tensor(a) for a in _k2_case("ragged")]
    before = nn_corr.fused_correspondence.launches
    out = nn_corr.fused_correspondence(*args)
    plain = nn_corr.fused_correspondence_plain(*args)
    assert nn_corr.fused_correspondence.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    # the twin is K3's plain scan plus the gather
    idx, d2 = nn_argmin.nearest_neighbor_plain(*args[:3])
    assert torch.equal(out[0], idx) and torch.equal(out[1], d2)


@pytest.mark.parametrize("bad", ["query_shape", "mask_dtype", "feats_m", "feats_0", "feats_129"])
def test_fused_correspondence_rejects_bad_inputs(bad):
    q, r = torch.zeros(2, 10, 3), torch.zeros(2, 20, 3)
    m, f = torch.ones(2, 20, dtype=torch.bool), torch.zeros(2, 20, 12)
    if bad == "query_shape":
        q = torch.zeros(2, 10, 4)
    elif bad == "mask_dtype":
        m = m.float()
    elif bad == "feats_m":
        f = torch.zeros(2, 21, 12)
    else:
        f = torch.zeros(2, 20, int(bad.split("_")[1]))
    with pytest.raises(ValueError):
        nn_corr.fused_correspondence(q, r, m, f)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """K2 and K3 share their scan through a header: a changed header gets a
    new build key too."""
    (tmp_path / "scan.cuh").write_text("// v1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "scan.cuh"\n')
    monkeypatch.setattr(nn_argmin, "SOURCE", str(src))
    p1 = cuda_build.library_path(nn_argmin.SOURCE)
    (tmp_path / "scan.cuh").write_text("// v2\n")
    assert cuda_build.library_path(nn_argmin.SOURCE) != p1


# ---- a plain model of K2's and K3's split, compacted scan (csrc/nn_scan.cuh) ---


def _split_scan_model(q, r, m, S):
    """What the kernel computes with the refs split into S slices: per
    problem the valid refs in index order (compaction), slice s holding
    those of rank [s V / S, (s + 1) V / S); each slice scanned in index
    order with a strict "<" (its first-index minimum), the slices combined
    in slice order with a strict "<" from (1e30, 0). The distance is the
    kernel's (each product and sum rounded on its own)."""
    B, N, _ = q.shape
    qx, qy, qz = (q[..., k, None] for k in range(3))  # [B, N, 1]
    qn = qx * qx + qy * qy + qz * qz
    best = torch.full((B, N), nn_argmin.BIG, dtype=q.dtype)
    idx = torch.zeros((B, N), dtype=torch.int32)
    for b in range(B):
        valid = torch.nonzero(m[b]).flatten()
        V = len(valid)
        for s in range(S):
            js = valid[V * s // S:V * (s + 1) // S]
            if not len(js):
                continue
            rx, ry, rz = (r[b, js, k][None] for k in range(3))  # [1, n]
            rn = rx * rx + ry * ry + rz * rz
            d2 = (qn[b] + rn) - 2.0 * (qx[b] * rx + qy[b] * ry + qz[b] * rz)  # [N, n]
            loc = torch.argmin(d2, dim=-1)  # the first index of the minimum
            smin = torch.take_along_dim(d2, loc[:, None], dim=-1)[:, 0]
            upd = smin < best[b]
            best[b] = torch.where(upd, smin, best[b])
            idx[b] = torch.where(upd, js[loc].to(torch.int32), idx[b])
    return idx, best


def _split_case(case, S, rng):
    """[B, N, 3], [B, M, 3], [B, M] numpy inputs for one model case, and the
    (query, ref) pairs where the query must pick that ref over its exact
    copies."""
    B, N, M = (2, 300, 1100) if case == "ragged" else (1, 256, 1024)
    q = (rng.normal(size=(B, N, 3)) * 10).astype(np.float32)
    r = (rng.normal(size=(B, M, 3)) * 10).astype(np.float32)
    m = rng.uniform(size=(B, M)) < (0.3 if case in ("masked70", "ties") else 0.9)
    if case == "all_masked":
        m[:] = False
    ties = []
    if case == "ties":
        # exact duplicates across the 512-ref chunk edge, and on either side
        # of every slice boundary (the last valid ref of a slice copied onto
        # the first of the next, a masked copy below), queries on them
        m[0, 500:530] = True
        valid = np.flatnonzero(m[0])
        used = set()
        for s in range(1, max(S, 2)):
            lo, hi = valid[len(valid) * s // max(S, 2) - 1], valid[len(valid) * s // max(S, 2)]
            r[0, hi] = r[0, lo]
            q[0, s] = r[0, lo]
            r[0, np.flatnonzero(~m[0, :lo])[-1]] = r[0, lo]
            ties.append((s, lo))
            used |= {lo, hi}
        for k in range(8):
            if not {500 + k, 512 + k} & used:
                r[0, 512 + k] = r[0, 500 + k]
                q[0, 100 + k] = r[0, 500 + k]
                ties.append((100 + k, 500 + k))
    return q, r, m, ties


@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["ties", "masked70", "all_masked", "ragged"])
def test_split_compacted_scan_model_equals_the_twins(case, S):
    """The split and the compaction change no bit: slice-wise first-index
    scans over the valid refs, combined in slice order, equal K3's twin
    (``nearest_neighbor_plain``) bitwise, and with K2's gather K2's twin
    (``fused_correspondence_plain``), for every S; M = 1100 is not a
    multiple of 3 or 8."""
    rng = np.random.default_rng(40 + S)
    *inputs, ties = _split_case(case, S, rng)
    q, r, m = (torch.as_tensor(a) for a in inputs)
    f = torch.as_tensor(rng.normal(size=(*m.shape, 12)).astype(np.float32))
    idx, d2 = _split_scan_model(q, r, m, S)
    pidx, pd2 = nn_argmin.nearest_neighbor_plain(q, r, m)
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2)
    rows = torch.take_along_dim(f, idx.long()[..., None], dim=1)
    g = torch.where((d2 < nn_argmin.BIG)[..., None], rows, 0.0)
    cidx, cd2, cg = nn_corr.fused_correspondence_plain(q, r, m, f)
    assert torch.equal(idx, cidx) and torch.equal(d2, cd2) and torch.equal(g, cg)
    if case == "all_masked":
        assert torch.all(d2 == nn_argmin.BIG) and torch.all(idx == 0) and torch.all(g == 0)
    assert all(int(idx[0, qi]) == j for qi, j in ties)  # the first valid copy wins
