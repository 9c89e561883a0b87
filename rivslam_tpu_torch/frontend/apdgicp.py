"""APDGICP scan registration (port of ``rivslam_tpu/frontend/apdgicp.py``):
covariance estimation, the exact LM/GN registration, and the method
dispatch.

The port batches over a leading problem dim B where the reference vmaps.
``prepare``, ``register_dispatch`` and ``prepare_and_register`` also take a
single unbatched problem, as the reference's do, and then return unbatched
results.

Two paths, as in the reference:
- the fast (structure-of-arrays) path, ``frontend/apdgicp_fast.py``, for
  PLANE covariances and FAST_APDGICP / FAST_GICP / GICP / GICP_OMP with
  ``use_fast_path`` (the default);
- the exact path here: ``estimate_covariances`` (KNN or RBF moments, every
  regularization) and ``register``, for ``use_fast_path=False``, the ICP and
  APDGICP methods, and any regularization other than PLANE. Its
  correspondence step is K2 (``ops/nn_corr``): one launch per step gathers
  each transformed source point's nearest target xyz and covariance.

Both registrations share one LM/GN loop: the reference's nested
``lax.while_loop``s become fixed-count functions of tensors over all B
problems with per-problem done masks. ``lm_iteration`` is one outer
iteration (the linearization, then always ``lm_max_iterations`` lambda
tries, ``lm_try``); a try or an iteration past done leaves that problem's
state bitwise unchanged, so B problems give what B separate reference calls
give. ``solve_lm`` runs the iterations eagerly and reads one flag from the
device after each; ``GraphedRegistration`` replays them as CUDA graphs on
the card (the Engine's odometry, and through ``register_dispatch`` every
registration handed no graphs: the scan-match entry, loop verification),
reading the same flag; when a key's graphs are captured is
``core/cuda_graph.GraphCache``'s rule.

VGICP and NDT (``frontend/vgicp.py``) are models for the same LM driver,
reached through ``register_dispatch``.

``register`` also takes a process ``group`` (the reference's ``axis_name``):
each rank holds part of the source points, and the sums the reference
psums (H, b and the error at each linearization, each try's error, the
final statistics) are summed over the group (``dist/dist_gn.py``'s
``sharded_register``). Without a group nothing changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from rivslam_tpu_torch.core import cuda_graph, lie
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import SENTINEL
from rivslam_tpu_torch.dist.mesh import all_sum
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.ops import eig3, knn, nn_corr

_FAST_METHODS = ("FAST_APDGICP", "FAST_GICP", "GICP", "GICP_OMP")
_VGICP_METHODS = ("VGICP", "FAST_VGICP", "FAST_VGICP_CUDA")
_VOXEL_METHODS = _VGICP_METHODS + ("NDT", "NDT_OMP", "NDT_CUDA")


@dataclasses.dataclass(frozen=True)
class PreparedCloud:
    """A cloud with precomputed regularized GICP covariances."""

    xyz: torch.Tensor  # [B, N, 3]
    mask: torch.Tensor  # [B, N]
    cov: torch.Tensor  # [B, N, 3, 3]


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    T: torch.Tensor  # [B, 4, 4] final source->target transform
    H: torch.Tensor  # [B, 6, 6] final Hessian (information of the estimate)
    error: torch.Tensor  # [B] final weighted error
    converged: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32 outer iterations used
    num_correspondences: torch.Tensor  # [B] int32 at the final linearization
    fitness: torch.Tensor  # [B] mean NN sq distance over matched points


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))).to(dev)


def _map(obj, fn):
    return type(obj)(**{f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _is_converged(delta_T: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """lsq_registration_impl.hpp:83-92, batched over leading dims."""
    eye = torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    R = delta_T[..., :3, :3] - eye
    t = delta_T[..., :3, 3]
    r_delta = torch.amax(torch.abs(R), dim=(-2, -1)) / cfg.rotation_epsilon
    t_delta = torch.amax(torch.abs(t), dim=-1) / cfg.transformation_epsilon
    return torch.maximum(r_delta, t_delta) < 1.0


def _se3_step(d: torch.Tensor) -> torch.Tensor:
    """[B, 6] step [w, t] -> 4x4 with R = exp(w), translation t (NOT
    se3_exp's coupled translation; lsq_registration_impl.hpp:140-143)."""
    return lie.se3_matrix(lie.so3_exp(d[:, :3]), d[:, 3:])


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-problem [B] condition broadcast over trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - 1)), a, b)


def _solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    # solve_ex: a singular system (a problem without correspondences) yields
    # inf/nan like the reference's LU solve instead of raising
    return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]


def lm_init(T0: torch.Tensor, cfg: RegistrationConfig) -> tuple:
    """The LM/GN carry before the first outer iteration: (T [B,4,4], lambda
    [B] (-1: unset, taken from H at the first linearization), converged,
    failed [B] bool, iterations [B] int32, H at the last accepted step
    [B,6,6])."""
    dtype, dev = T0.dtype, T0.device
    B = T0.shape[0]
    return (
        T0.clone(),
        torch.full((B,), -1.0, dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.eye(6, dtype=dtype, device=dev).expand(B, 6, 6).clone(),
    )


def lm_active(carry: tuple, cfg: RegistrationConfig) -> torch.Tensor:
    """[B] problems that still iterate: neither converged nor failed, and
    under the iteration cap."""
    _, _, converged, failed, it, _ = carry
    return ~converged & ~failed & (it < cfg.max_iterations)


def lm_try(tries: tuple, H, b, y0, T, ctx, cfg: RegistrationConfig, error_at) -> tuple:
    """One try of the lambda search (lsq_registration_impl.hpp:125-173) over
    the tries' state (T_i, lam_i, nu, done, success, conv_i, dlast). A
    problem whose search is done (a try accepted, or the rejected step
    converged) comes out bitwise unchanged."""
    T_i, lam_i, nu, done, success, conv_i, dlast = tries
    run = ~done
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    d = _solve(H + lam_i[:, None, None] * eye6, -b)
    delta = _se3_step(d)
    T_new = delta @ T
    yi = error_at(T_new, ctx)
    denom = torch.sum(d * (lam_i[:, None] * d - b), dim=-1)
    rho = (y0 - yi) / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    accept = rho >= 0.0
    conv_rej = _is_converged(delta, cfg)
    grow = torch.clamp_min(1 - (2 * rho - 1) ** 3, 1 / 3)
    return (
        _where(run & accept, T_new, T_i),
        torch.where(run, torch.where(accept, lam_i * grow, nu * lam_i), lam_i),
        torch.where(run & ~accept, 2 * nu, nu),
        torch.where(run, accept | conv_rej, done),
        torch.where(run, accept, success),
        torch.where(run, conv_rej & ~accept, conv_i),
        _where(run & accept, delta, dlast),
    )


def _summed(linearize_at, error_at, group):
    """The model's functions with H, b and y0 at each linearization and the
    error of each try summed over ``group`` (the reference's ``_reduce``,
    a psum over the mesh axis that shards the source points)."""
    def lin(T):
        H, b, y0, ctx = linearize_at(T)
        return all_sum(H, group), all_sum(b, group), all_sum(y0, group), ctx

    return lin, lambda T, ctx: all_sum(error_at(T, ctx), group)


def lm_iteration(carry: tuple, cfg: RegistrationConfig, linearize_at, error_at, group=None) -> tuple:
    """One outer LM (or GN) iteration over B problems with no host read:
    ``linearize_at(T) -> (H [B,6,6], b [B,6], y0 [B], ctx)`` fixes the
    correspondences at T, ``error_at(T, ctx) -> [B]`` is the error under
    them. LM always runs ``cfg.lm_max_iterations`` tries (``lm_try``); a
    problem that is not active (``lm_active``) comes out bitwise unchanged.
    With a process ``group`` (each rank holding part of the source points)
    H, b, y0 and each try's error are summed over it, so every rank steps
    alike. Returns the next carry (``lm_init``)."""
    if group is not None:
        linearize_at, error_at = _summed(linearize_at, error_at, group)
    T, lam, converged, failed, it, Hf = carry
    active = lm_active(carry, cfg)
    H, b, y0, ctx = linearize_at(T)
    if cfg.optimizer == "GN":
        # step_gn (lsq_registration_impl.hpp:107-123): one undamped solve
        delta = _se3_step(_solve(H, -b))
        return (
            _where(active, delta @ T, T), lam,
            torch.where(active, _is_converged(delta, cfg), converged), failed,
            it + active.to(torch.int32), _where(active, H, Hf),
        )

    B = T.shape[0]
    diag_max = torch.amax(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1)
    lam_i = torch.where(lam < 0, cfg.lm_init_lambda_factor * diag_max, lam)
    done = ~active
    tries = (
        T, lam_i, torch.full((B,), 2.0, dtype=T.dtype, device=T.device), done,
        torch.zeros_like(done), torch.zeros_like(done),
        torch.eye(4, dtype=T.dtype, device=T.device).expand(B, 4, 4),
    )
    for _ in range(cfg.lm_max_iterations):
        tries = lm_try(tries, H, b, y0, T, ctx, cfg, error_at)
    T_i, lam_i, _, _, success, conv_i, dlast = tries
    return (
        _where(active, T_i, T),
        torch.where(active, lam_i, lam),
        torch.where(active, torch.where(success, _is_converged(dlast, cfg), conv_i), converged),
        torch.where(active, ~success & ~conv_i, failed),
        it + active.to(torch.int32),
        _where(active & success, H, Hf),
    )


def solve_lm(T0: torch.Tensor, cfg: RegistrationConfig, linearize_at, error_at, group=None):
    """The LsqRegistration LM/GN loop (lsq_registration_impl.hpp:55-173)
    over B problems, eagerly: ``lm_iteration`` up to ``cfg.max_iterations``
    times, reading one flag from the device after each (whether any problem
    is still active). Returns (T, H at the last accepted step, converged,
    iterations). The outer iterations run count under the tracer's
    ``lm_iterations``, by the span open around the call."""
    with timing.span("apdgicp.solve_lm"):
        carry = lm_init(T0, cfg)
        run = 0
        for i in range(cfg.max_iterations):
            carry = lm_iteration(carry, cfg, linearize_at, error_at, group)
            run += 1
            if i + 1 < cfg.max_iterations and not bool(lm_active(carry, cfg).any()):
                break
    timing.count("lm_iterations", n=run)
    T, _, converged, _, it, Hf = carry
    return T, Hf, converged, it


def _registration_eagerly(model, problem: tuple, T0: torch.Tensor, cfg: RegistrationConfig,
                          group=None) -> tuple:
    """``solve_lm`` and the final step of one registration, eagerly:
    (T, H, converged, iterations, error, correspondences, fitness). Counts
    one ``registrations_eager`` by the span open around the call."""
    linearize_at, error_at, final_at = (
        model(*problem, cfg) if group is None else model(*problem, cfg, group=group))
    T, Hf, converged, it = solve_lm(T0, cfg, linearize_at, error_at, group)
    out = (T, Hf, converged, it, *final_at(T))
    timing.count("registrations_eager")
    return out


def run_registration(model, problem: tuple, T0: torch.Tensor, cfg: RegistrationConfig,
                     graphs: GraphedRegistration | None = None, group=None) -> RegistrationResult:
    """``solve_lm`` and the final correspondence statistics of one
    registration. ``model(*problem, cfg) -> (linearize_at, error_at,
    final_at)`` builds the path's functions over its fixed inputs
    ``problem`` (tensors); ``final_at(T) -> (error, correspondences,
    fitness)``. With ``graphs`` (on the card) the iteration and the final
    step replay CUDA graphs, once ``graphs`` has captured the key; without,
    they run eagerly, as on the CPU. With a process ``group`` (the
    model-parallel registration: each rank holds part of the source points)
    the sums are taken over the group and the model is built as
    ``model(*problem, cfg, group=group)``; that runs eagerly. The tracer
    counts one registration under ``registrations_graphed`` or
    ``registrations_eager``, by the path it took."""
    if graphs is not None and group is not None:
        raise ValueError("a registration summed over a process group runs eagerly (graphs=None)")
    if graphs is not None:
        T, Hf, converged, it, error, ncorr, fitness = graphs(model, problem, T0, cfg)
    else:
        T, Hf, converged, it, error, ncorr, fitness = _registration_eagerly(model, problem, T0, cfg, group)
    return RegistrationResult(
        T=T, H=Hf, error=error, converged=converged, iterations=it,
        num_correspondences=ncorr, fitness=fitness,
    )


class GraphedRegistration:
    """The registration on the card as CUDA graphs, held by a
    ``core/cuda_graph.GraphCache`` (``cache``, capturing on a key's
    ``capture_on``-th sight; the sights before run eagerly). The key is the
    path's ``model``, the configuration (method, optimizer,
    ``use_pallas_correspondence``) and the shapes and dtypes of the fixed
    inputs and of T0 (B, N, M, F). Each key holds two graphs over shared
    static inputs (the fixed inputs and the LM carry): one outer iteration
    (``lm_iteration``), which writes its next carry back into its inputs and
    leaves whether any problem is still active, and the final step. A
    registration copies its inputs in, replays the iteration reading that
    flag after each replay (at most ``cfg.max_iterations``), then the final
    step; the tracer counts the iterations under ``lm_iterations``, the
    registration under ``registrations_graphed``.

    ``shared``: callers on several threads and streams (the module's own
    store, ``register_dispatch``'s): each registration holds
    ``core/cuda_graph.LOCK`` from its load to its outputs' clones, so that
    two threads never interleave on one key's static inputs, and its stream
    waits for the last registration's."""

    def __init__(self, capture_on: int = 1, shared: bool = False):
        self.cache = cuda_graph.GraphCache(self._capture, capture_on)
        self.reads = 0  # host reads of the active flag
        self._lock = cuda_graph.LOCK if shared else contextlib.nullcontext()
        self._shared = shared
        self._stream = None  # the stream of the last registration (shared)

    @property
    def replays(self) -> int:
        return self.cache.replays

    def launches_by_shape(self) -> dict:
        """Kernel launches credited through the replays so far, by
        registration shape (B, N, M): {shape: {"K1": n, "K2": n}}."""
        names = {"fused_gather": "K1", "fused_correspondence": "K2"}
        out: dict = {}
        for key, pair in self.cache.graphs.items():
            shapes = key[-1]  # the fixed inputs': source xyz first, target mask fifth
            shape = (shapes[0][0][0], shapes[0][0][1], shapes[4][0][1])
            counts = out.setdefault(shape, {})
            for g in pair:
                for fn, n in g.launches.items():
                    name = names[fn.__name__]
                    counts[name] = counts.get(name, 0) + n * g.replays
        return out

    @staticmethod
    def _capture(model, cfg, T0, *problem):
        n = len(problem)
        inputs = [t.clone() for t in (*problem, *lm_init(T0, cfg))]

        def iteration(*args):
            linearize_at, error_at, _ = model(*args[:n], cfg)
            carry = args[n:]
            new = lm_iteration(carry, cfg, linearize_at, error_at)
            for dst, src in zip(carry, new):
                dst.copy_(src)
            return (lm_active(new, cfg).any(),)

        def final(*args):
            return model(*args[:n], cfg)[2](args[n])

        name = f"{model.__name__}[{'x'.join(map(str, problem[0].shape))}]"
        return (cuda_graph.Graphed(f"registration iteration {name}", iteration, inputs),
                cuda_graph.Graphed(f"registration final {name}", final, inputs))

    def capture_deferred(self) -> int:
        """The cache's ``capture_deferred``, under the store's lock."""
        with self._lock:
            return self.cache.capture_deferred()

    def __call__(self, model, problem: tuple, T0: torch.Tensor, cfg: RegistrationConfig):
        key = (model, cfg, T0.dtype, tuple(T0.shape),
               tuple((tuple(t.shape), t.dtype) for t in problem))
        with self._lock:
            graphs = self.cache.get(key, model, cfg, T0, *problem)
            if graphs is None:
                return _registration_eagerly(model, problem, T0, cfg)
            if self._shared and T0.is_cuda:
                stream = torch.cuda.current_stream(T0.device)
                if self._stream is not None and self._stream != stream:
                    stream.wait_stream(self._stream)
                self._stream = stream
            iteration, final = graphs
            iteration.load(*problem, *lm_init(T0, cfg))
            run = 0
            for i in range(cfg.max_iterations):
                with timing.span("registration.replay"):
                    (active,) = iteration.replay()
                run += 1
                if i + 1 < cfg.max_iterations:
                    self.reads += 1
                    with timing.span("registration.active_read"):
                        still = bool(active)
                    if not still:
                        break
            timing.count("lm_iterations", n=run)
            out = final.replay()
            T, _, converged, _, it, Hf = iteration.inputs[len(problem):]
            result = tuple(t.clone() for t in (T, Hf, converged, it, *out))
        timing.count("registrations_graphed")
        return result


# ---- the exact path ---------------------------------------------------------


def _regularize(cov: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "NONE":
        return cov
    if kind == "PLANE":
        return eig3.plane_regularize(cov, 1e-3)
    if kind in ("MIN_EIG", "NORMALIZED_MIN_EIG"):
        vals, vecs = torch.linalg.eigh(cov)
        if kind == "MIN_EIG":
            new_vals = torch.clamp_min(vals, 1e-3)
        else:
            new_vals = torch.clamp_min(vals / torch.clamp_min(vals[..., -1:], 1e-12), 1e-3)
        return torch.einsum("...ij,...j,...kj->...ik", vecs, new_vals, vecs)
    raise ValueError(f"unknown regularization {kind}")


def estimate_covariances(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: RegistrationConfig
) -> PreparedCloud:
    """k-NN or RBF covariances with cfg.regularization
    (fast_apdgicp_impl.hpp:300-363; covariance_estimation_rbf.cu:78-160),
    batched: xyz [B, N, 3], mask [B, N]."""
    sxyz = torch.where(mask[..., None], xyz, SENTINEL)
    if cfg.covariance_method == "RBF":
        # w = exp(-kw * d2), zeroed beyond max_dist; cov = E_w[xx^T] - mean mean^T
        d2 = knn.pairwise_sqdist(sxyz, sxyz)
        w = torch.exp(-cfg.rbf_kernel_width * d2)
        w = torch.where((d2 <= cfg.rbf_max_dist**2) & mask[..., None, :], w, 0.0).to(xyz.dtype)
        sw = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-6)
        mean = (w @ xyz) / sw
        # E_w[xx^T] as one matmul against the per-point outer products (no
        # [N, M, 3, 3] intermediate)
        outer = (xyz[..., :, None] * xyz[..., None, :]).flatten(-2)  # [..., M, 9]
        exx = ((w @ outer) / sw).unflatten(-1, (3, 3))
        cov = exx - mean[..., :, None] * mean[..., None, :]
    else:
        idx, d2 = knn.knn(sxyz, sxyz, mask, cfg.k_correspondences)
        nb = torch.take_along_dim(xyz[..., None, :, :], idx[..., None].long(), dim=-2)  # [B,N,k,3]
        w = torch.isfinite(d2).to(xyz.dtype)  # valid neighbour flags
        wn = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
        mean = torch.sum(nb * w[..., None], dim=-2) / wn
        cent = (nb - mean[..., None, :]) * w[..., None]
        # as the reference: divided by the valid count (k with full scans)
        cov = torch.einsum("...ki,...kj->...ij", cent, cent) / wn[..., None]
    return PreparedCloud(xyz=xyz, mask=mask, cov=_regularize(cov, cfg.regularization))


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741 (the adjugate's standard names)
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1.0, det)
    adj = torch.stack(
        [torch.stack([A, D, G], dim=-1), torch.stack([B, E, H], dim=-1),
         torch.stack([C, F, I], dim=-1)],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def adaptive_cov(pt: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """Per-point APD covariance C_dist = R diag(s)^2 R^T of the TRANSFORMED
    source point (fast_apdgicp_impl.hpp:163-184)."""
    x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
    dist = torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-12))
    cos_aoa = torch.cos(torch.atan2(x, torch.sqrt(y * y + z * z)))
    safe_cos = torch.where(torch.abs(cos_aoa) < 1e-6, 1e-6, cos_aoa)
    s_x = dist * cfg.dist_var / 400.0
    s_y = dist * math.sin(math.radians(cfg.azimuth_var)) / safe_cos
    s_z = dist * math.sin(math.radians(cfg.elevation_var)) / safe_cos
    elevation = torch.atan2(torch.sqrt(x * x + y * y), z)
    azimuth = torch.atan2(y, x)
    # R = Rz(azimuth) @ Ry(elevation)
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    ce, se = torch.cos(elevation), torch.sin(elevation)
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)
    Rz = torch.stack(
        [torch.stack([ca, -sa, zeros], dim=-1), torch.stack([sa, ca, zeros], dim=-1),
         torch.stack([zeros, zeros, ones], dim=-1)],
        dim=-2,
    )
    Ry = torch.stack(
        [torch.stack([ce, zeros, se], dim=-1), torch.stack([zeros, ones, zeros], dim=-1),
         torch.stack([-se, zeros, ce], dim=-1)],
        dim=-2,
    )
    R = Rz @ Ry
    s2 = torch.stack([s_x * s_x, s_y * s_y, s_z * s_z], dim=-1)
    return torch.einsum("...ij,...j,...kj->...ik", R, s2, R)


@dataclasses.dataclass(frozen=True)
class _Corr:
    """Correspondences fixed at one linearization point."""

    idx: torch.Tensor  # [B, N] int32 the nearest valid target
    tgt: torch.Tensor  # [B, N, 3] its xyz
    corr: torch.Tensor  # [B, N] bool
    mah: torch.Tensor  # [B, N, 3, 3] Mahalanobis weights (0 off corr)
    d2: torch.Tensor  # [B, N] NN squared distances, clamped at 0


def _correspondences(T, source: PreparedCloud, tgt_sent, tgt_mask, tgt_feats, cfg):
    """NN correspondences + Mahalanobis (fast_apdgicp_impl.hpp:133-193).

    The nearest target, its xyz and its covariance come from one K2 launch
    (its plain twin on CPU tensors). K2's d2 is unclamped; the reference's
    ``knn.pairwise_sqdist`` clamps at 0, so it is clamped here for the gate
    and the fitness."""
    pt = lie.transform_points(T, source.xyz)
    idx, d2, g = nn_corr.fused_correspondence(pt.contiguous(), tgt_sent, tgt_mask, tgt_feats)
    d2 = torch.clamp_min(d2.to(pt.dtype), 0.0)
    g = g.to(pt.dtype)
    corr = source.mask & (d2 < cfg.max_correspondence_distance**2)
    cov_A = source.cov
    cov_B = g[..., 3:].reshape(g.shape[:-1] + (3, 3))
    if cfg.method == "FAST_APDGICP":
        cd = adaptive_cov(pt, cfg)
    else:  # no adaptive term (the reference applies it to FAST_APDGICP only)
        cd = torch.zeros_like(cov_A)
    R = T[:, None, :3, :3]
    rcr = (cov_B + cd) + R @ (cov_A + cd) @ R.transpose(-1, -2)
    mah = _inv3(rcr)
    if cfg.method == "ICP":
        # plain point-to-point ICP (registrations.cpp:52): identity weighting
        mah = torch.eye(3, dtype=mah.dtype, device=mah.device).expand(mah.shape)
    mah = torch.where(corr[..., None, None], mah, 0.0)
    return _Corr(idx=idx, tgt=g[..., :3], corr=corr, mah=mah, d2=d2)


def _linearize(T, source: PreparedCloud, c: _Corr):
    """H, b, error from fixed correspondences (fast_apdgicp_impl.hpp:221-260)."""
    pt = lie.transform_points(T, source.xyz)
    e = c.tgt - pt  # [B, N, 3]
    me = torch.einsum("...nij,...nj->...ni", c.mah, e)
    err = torch.sum(torch.where(c.corr, torch.sum(e * me, dim=-1), 0.0), dim=-1)
    # J = d e / d [w, t] = [skew(pt), -I]   (3x6)
    neg_eye = -torch.eye(3, dtype=pt.dtype, device=pt.device).expand(pt.shape + (3,))
    J = torch.cat([lie.hat(pt), neg_eye], dim=-1)  # [B, N, 3, 6]
    MJ = c.mah @ J
    H = torch.einsum("...nji,...njk->...ik", J, MJ)
    b = torch.einsum("...nji,...nj->...i", J, me)
    return H, b, err


def _compute_error(T, source: PreparedCloud, c: _Corr):
    """Error at T under FIXED correspondences (fast_apdgicp_impl.hpp:275-298)."""
    e = c.tgt - lie.transform_points(T, source.xyz)
    quad = torch.einsum("...nij,...ni,...nj->...n", c.mah, e, e)
    return torch.sum(torch.where(c.corr, quad, 0.0), dim=-1)


def exact_problem(source: PreparedCloud, target: PreparedCloud) -> tuple:
    """The fixed inputs of an exact registration: the source's xyz, mask and
    covariance, the target with masked rows at the sentinel, its mask, and
    what K2 gathers per target (xyz and the full covariance, F = 3 + 9)."""
    B, M = target.xyz.shape[:2]
    tmask = target.mask.contiguous()
    tgt_sent = torch.where(tmask[..., None], target.xyz, SENTINEL).contiguous()
    tgt_feats = torch.cat([target.xyz, target.cov.reshape(B, M, 9)], dim=-1).contiguous()
    return (source.xyz.contiguous(), source.mask.contiguous(), source.cov.contiguous(),
            tgt_sent, tmask, tgt_feats)


def exact_model(src_xyz, src_mask, src_cov, tgt_sent, tmask, tgt_feats, cfg: RegistrationConfig,
                group=None):
    """``run_registration``'s functions for the exact path over
    ``exact_problem``'s inputs. With a process ``group`` the final
    correspondence count, the fitness numerator and the final error are
    summed over it (the iteration's sums are ``lm_iteration``'s)."""
    source = PreparedCloud(xyz=src_xyz, mask=src_mask, cov=src_cov)

    def reduce(x):
        return x if group is None else all_sum(x, group)

    def linearize_at(T):
        c = _correspondences(T, source, tgt_sent, tmask, tgt_feats, cfg)
        return (*_linearize(T, source, c), c)

    def error_at(T, c):
        return _compute_error(T, source, c)

    def final_at(T):
        # final correspondence stats at the solution
        c = _correspondences(T, source, tgt_sent, tmask, tgt_feats, cfg)
        ncorr = reduce(torch.sum(c.corr, dim=-1))
        fitness = reduce(torch.sum(torch.where(c.corr, c.d2, 0.0), dim=-1)) / torch.clamp_min(ncorr, 1)
        _, _, final_err = _linearize(T, source, c)
        return reduce(final_err), ncorr.to(torch.int32), fitness

    return linearize_at, error_at, final_at


def register(
    source: PreparedCloud, target: PreparedCloud, guess: torch.Tensor, cfg: RegistrationConfig,
    graphs: GraphedRegistration | None = None, group=None,
) -> RegistrationResult:
    """Exact LM/GN alignment of B sources onto B targets (the reference's
    ``register``): fields [B, N, ...], guess [B, 4, 4]; ``graphs`` and
    ``group`` (the reference's ``axis_name``: this rank holds part of the
    source points, the target is whole) as in ``run_registration``."""
    return run_registration(exact_model, exact_problem(source, target),
                            guess.to(source.xyz.dtype), cfg, graphs, group)


# ---- dispatch -----------------------------------------------------------------


def prepare(xyz, mask, cfg: RegistrationConfig, device="cuda") -> PreparedCloud:
    """Covariance estimation honoring cfg.use_fast_path and
    cfg.covariance_method (KNN | RBF). xyz [B, N, 3] or [N, 3]."""
    dev = resolve(device)
    xyz = _as_tensor(xyz, dev)
    mask = _as_tensor(mask, dev)
    if xyz.ndim == 2:
        return _map(prepare(xyz[None], mask[None], cfg, dev), lambda t: t[0])
    with timing.span("apdgicp.prepare"):
        if cfg.use_fast_path and cfg.regularization == "PLANE":
            from rivslam_tpu_torch.frontend import apdgicp_fast

            if cfg.covariance_method == "RBF":
                return apdgicp_fast.estimate_covariances_rbf_fast(xyz, mask, cfg)
            return apdgicp_fast.estimate_covariances_fast(xyz, mask, cfg)
        return estimate_covariances(xyz, mask, cfg)


# the graphs of the registrations handed none (the scan-match entry, loop
# verification) on the card, made on first use
_graphs: GraphedRegistration | None = None


def _module_graphs() -> GraphedRegistration:
    global _graphs
    if _graphs is None:
        _graphs = GraphedRegistration(capture_on=2, shared=True)
    return _graphs


def capture_deferred() -> int:
    """The module store's ``capture_deferred``: the captures that fell due
    on the loop worker, made on this thread (the Engine calls it on the
    frame's thread once it has merged a worker job). Returns how many it
    made."""
    return 0 if _graphs is None else _graphs.capture_deferred()


def register_dispatch(
    source: PreparedCloud, target: PreparedCloud, guess, cfg: RegistrationConfig,
    device="cuda", graphs: GraphedRegistration | None = None, eager: bool = False,
) -> RegistrationResult:
    """Method factory (registrations.cpp:38-140): FAST_APDGICP / FAST_GICP /
    GICP / GICP_OMP take the structure-of-arrays fast path when
    cfg.use_fast_path; VGICP / FAST_VGICP / FAST_VGICP_CUDA and NDT /
    NDT_OMP / NDT_CUDA voxelize the target (``frontend/vgicp.py``): VGICP
    into fast_gicp's additive map of the target's point covariances, NDT
    into its point spread (point-to-distribution); everything else takes
    the exact ``register`` (ICP drops the Mahalanobis metric).

    The LM replays CUDA graphs on the card: the caller's ``graphs`` (the
    Engine's odometry hands its own), else the module's own store for every
    method (``GraphedRegistration``, shared by threads; its
    ``core/cuda_graph.GraphCache`` holds the newest four keys), which runs a
    key's first registration eagerly, captures on its second and replays
    from then on, so that a registration made once pays no capture. Eagerly an outer LM iteration is ~1,000 (K1's
    path) to ~1,300 (the voxel match) small operations and 10 lambda tries,
    ~20-40 ms of host dispatch against a few ms of device work. ``eager=True``
    and the CPU run eagerly. The voxel map's build is the span
    ``registration.voxel_map``, and the tracer's ``voxel_maps`` counts the
    maps built (one a problem)."""
    dev = resolve(device)
    if graphs is None and not eager and dev.type == "cuda":
        graphs = _module_graphs()
    source = _map(source, lambda t: t.to(dev))
    target = _map(target, lambda t: t.to(dev))
    guess = _as_tensor(guess, dev)
    if source.xyz.ndim == 2:
        batched = register_dispatch(
            _map(source, lambda t: t[None]), _map(target, lambda t: t[None]),
            guess[None], cfg, dev, graphs, eager,
        )
        return _map(batched, lambda t: t[0])
    m = cfg.method
    if m in _VOXEL_METHODS:
        from rivslam_tpu_torch.frontend import vgicp

        is_vgicp = m in _VGICP_METHODS
        with timing.span("registration.voxel_map"):
            vm = vgicp.build_voxel_map(target.xyz, target.mask, cfg, cov=target.cov if is_vgicp else None)
        timing.count("voxel_maps", n=target.xyz.shape[0])
        if is_vgicp:
            return vgicp.register_vgicp(source, vm, guess, cfg, graphs=graphs)
        return vgicp.register_ndt(source.xyz, source.mask, vm, guess, cfg,
                                  src_capacity=source.xyz.shape[-2], graphs=graphs)
    if cfg.use_fast_path and m in _FAST_METHODS:
        from rivslam_tpu_torch.frontend import apdgicp_fast

        return apdgicp_fast.register_fast(source, target, guess, cfg, graphs)
    return register(source, target, guess, cfg, graphs)


def prepare_and_register(
    src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: RegistrationConfig,
    device="cuda",
) -> RegistrationResult:
    """Convenience: covariance estimation + registration in one call."""
    source = prepare(src_xyz, src_mask, cfg, device)
    target = prepare(tgt_xyz, tgt_mask, cfg, device)
    return register_dispatch(source, target, guess, cfg, device)
