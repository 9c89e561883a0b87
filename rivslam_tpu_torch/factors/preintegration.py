"""IMU preintegration, Forster-style midpoint (port of
``rivslam_tpu/factors/preintegration.py``; imu_preintegration.cpp:14-95).

Everything that depends only on the measurements and the fixed start
biases is computed for all samples at once; the true recurrences (the
delta state, the bias Jacobians, the 9x9 covariance in 3x3 blocks) run as a
loop over the fixed IMU capacity K, the counterpart of the reference's
``lax.scan``: a masked sample keeps the state bitwise unchanged
(``torch.where``), as the reference's does. The host reads nothing, so the
whole call has one fixed shape per K: on the card the engine captures it
as a CUDA graph the first time it sees a buffer of K samples
(``GraphedPreintegrate``) and replays that graph for every later one.
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import cuda_graph, lie
from rivslam_tpu_torch.core.navstate import GRAVITY, NavState
from rivslam_tpu_torch.eval import timing


@dataclasses.dataclass(frozen=True)
class Preintegration:
    """Integrated IMU delta between two frames (+ bias Jacobians, covariance).
    All fields may carry leading batch dims (window stacking)."""

    dt: torch.Tensor  # [] total integration time
    dR: torch.Tensor  # [3,3]
    dv: torch.Tensor  # [3]
    dp: torch.Tensor  # [3]
    dR_dbg: torch.Tensor  # [3,3]
    dV_dbg: torch.Tensor  # [3,3]
    dV_dba: torch.Tensor  # [3,3]
    dP_dbg: torch.Tensor  # [3,3]
    dP_dba: torch.Tensor  # [3,3]
    cov: torch.Tensor  # [9,9] order (theta, v, p) like the reference
    bg: torch.Tensor  # [3] reference gyro bias used during integration
    ba: torch.Tensor  # [3] reference accel bias

    @staticmethod
    def identity(dtype=torch.float32, device="cpu") -> "Preintegration":
        z3 = torch.zeros(3, dtype=dtype, device=device)
        z33 = torch.zeros((3, 3), dtype=dtype, device=device)
        return Preintegration(
            dt=torch.zeros((), dtype=dtype, device=device),
            dR=torch.eye(3, dtype=dtype, device=device),
            dv=z3, dp=z3, dR_dbg=z33, dV_dbg=z33, dV_dba=z33, dP_dbg=z33, dP_dba=z33,
            cov=torch.zeros((9, 9), dtype=dtype, device=device), bg=z3, ba=z3,
        )

    def astuple(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product batched over leading dims (``A @ v`` would read
    a batch of vectors as a matrix)."""
    return (A @ v[..., None])[..., 0]


def preintegrate(
    dts: torch.Tensor,  # [K] per-sample dt (seconds); masked samples ignored
    acc: torch.Tensor,  # [K, 3] accelerometer
    gyr: torch.Tensor,  # [K, 3] gyroscope
    mask: torch.Tensor,  # [K] valid samples
    bg: torch.Tensor,  # [3] gyro bias at integration start
    ba: torch.Tensor,  # [3] accel bias
    noise_gyro: float,
    noise_acc: float,
) -> Preintegration:
    """Integrate a masked IMU buffer with the reference's midpoint scheme,
    including its first-sample ``last = current`` convention (cpp:15-18)."""
    ng2 = noise_gyro * noise_gyro
    na2 = noise_acc * noise_acc
    K = dts.shape[0]

    # midpoint partner: the last VALID sample before k
    idx = torch.arange(K, device=dts.device)
    seen = torch.cummax(torch.where(mask, idx, -1), dim=0).values
    prev_valid = torch.cat([torch.full((1,), -1, dtype=idx.dtype, device=idx.device), seen[:-1]])
    last_idx = torch.where(prev_valid >= 0, prev_valid, idx)
    gyr_m = 0.5 * (gyr[last_idx] + gyr) - bg
    acc_m = 0.5 * (acc[last_idx] + acc) - ba
    omega = gyr_m * dts[:, None]
    deltaR = lie.so3_exp(omega)  # [K,3,3]
    rightJ = lie.so3_right_jacobian(omega)
    acc_hat = lie.hat(acc_m)
    Q_theta = ng2 * dts[:, None, None] ** 2 * torch.einsum("kij,klj->kil", rightJ, rightJ)

    p = dataclasses.replace(Preintegration.identity(dts.dtype, dts.device), bg=bg, ba=ba)
    for k in range(K):
        dt = dts[k]
        dR_k, rJ, ah, am, Qth = deltaR[k], rightJ[k], acc_hat[k], acc_m[k], Q_theta[k]
        dt2 = dt * dt
        dR = p.dR
        dp_new = p.dp + p.dv * dt + mv(0.5 * dR, am) * dt2
        dv_new = p.dv + mv(dR, am) * dt

        # cov' = A cov A^T + B Sigma B^T in 3x3 blocks, with
        # A = [[a, 0, 0], [b, I, 0], [0.5 dt b, dt I, I]], a = deltaR^T,
        # b = -dR acc_hat dt (imu_preintegration.cpp:25-37,63-64)
        a = dR_k.T
        b = -(dR @ ah) * dt
        C = p.cov
        C00, C01, C02 = C[0:3, 0:3], C[0:3, 3:6], C[0:3, 6:9]
        C11, C12, C22 = C[3:6, 3:6], C[3:6, 6:9], C[6:9, 6:9]
        M00, M01, M02 = a @ C00, a @ C01, a @ C02
        bC00, bC01, bC02 = b @ C00, b @ C01, b @ C02
        M10, M11, M12 = bC00 + C01.T, bC01 + C11, bC02 + C12
        M20 = 0.5 * dt * bC00 + dt * C01.T + C02.T
        M21 = 0.5 * dt * bC01 + dt * C11 + C12.T
        M22 = 0.5 * dt * bC02 + dt * C12 + C22
        N00 = M00 @ a.T
        M00bT, M10bT, M20bT = M00 @ b.T, M10 @ b.T, M20 @ b.T
        N01 = M00bT + M01
        N02 = 0.5 * dt * M00bT + dt * M01 + M02
        N11 = M10bT + M11
        N12 = 0.5 * dt * M10bT + dt * M11 + M12
        N22 = 0.5 * dt * M20bT + dt * M21 + M22
        S = (na2 * dt2) * (dR @ dR.T)
        N00 = N00 + Qth
        N11 = N11 + S
        N12 = N12 + 0.5 * dt * S
        N22 = N22 + 0.25 * dt2 * S
        cov = torch.cat([
            torch.cat([N00, N01, N02], dim=1),
            torch.cat([N01.T, N11, N12], dim=1),
            torch.cat([N02.T, N12.T, N22], dim=1),
        ], dim=0)

        dRah = dR @ ah
        p_new = Preintegration(
            dt=p.dt + dt,
            dR=dR @ dR_k,
            dv=dv_new,
            dp=dp_new,
            dR_dbg=dR_k.T @ p.dR_dbg - rJ * dt,
            dV_dbg=p.dV_dbg - dRah @ p.dR_dbg * dt,
            dV_dba=p.dV_dba - dR * dt,
            dP_dbg=p.dP_dbg + p.dV_dbg * dt - 0.5 * dRah @ p.dR_dbg * dt2,
            dP_dba=p.dP_dba + p.dV_dba * dt - 0.5 * dR * dt2,
            cov=cov,
            bg=p.bg,
            ba=p.ba,
        )
        p = Preintegration(*(torch.where(mask[k], a, b) for a, b in zip(p_new.astuple(), p.astuple())))
    return p


class GraphedPreintegrate:
    """``preintegrate`` on the card as CUDA graphs, one per IMU buffer
    length: the whole masked loop over K samples is captured the first time
    a buffer of K samples comes, and every call copies the frame's buffers
    into that graph's static inputs and replays it."""

    def __init__(self, noise_gyro: float, noise_acc: float, dtype, device):
        self.noise = (noise_gyro, noise_acc)
        self.dtype, self.device = dtype, device
        self._graphs: dict[int, cuda_graph.Graphed] = {}

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs.values())

    def _capture(self, capacity: int) -> cuda_graph.Graphed:
        kw = dict(dtype=self.dtype, device=self.device)
        inputs = [
            torch.full((capacity,), 0.005, **kw), torch.zeros((capacity, 3), **kw),
            torch.zeros((capacity, 3), **kw), torch.ones(capacity, dtype=torch.bool, device=self.device),
            torch.zeros(3, **kw), torch.zeros(3, **kw),
        ]
        return cuda_graph.Graphed(
            f"preintegrate[{capacity}]",
            lambda *a: preintegrate(*a, *self.noise).astuple(),
            inputs,
        )

    def __call__(self, dts, acc, gyr, mask, bg, ba) -> Preintegration:
        K = dts.shape[0]
        if K not in self._graphs:
            self._graphs[K] = self._capture(K)
        graph = self._graphs[K]
        with timing.span("preintegrate.load"):
            graph.load(dts, acc, gyr, mask, bg, ba)
        with timing.span("preintegrate.replay"):
            return Preintegration(*(t.clone() for t in graph.replay()))


def delta_rotation(p: Preintegration, bg: torch.Tensor) -> torch.Tensor:
    """dR corrected to bias bg (imu_preintegration.cpp:74)."""
    return p.dR @ lie.so3_exp(mv(p.dR_dbg, bg - p.bg))


def delta_velocity(p: Preintegration, bg: torch.Tensor, ba: torch.Tensor) -> torch.Tensor:
    return p.dv + mv(p.dV_dbg, bg - p.bg) + mv(p.dV_dba, ba - p.ba)


def delta_position(p: Preintegration, bg: torch.Tensor, ba: torch.Tensor) -> torch.Tensor:
    return p.dp + mv(p.dP_dbg, bg - p.bg) + mv(p.dP_dba, ba - p.ba)


def gravity_vector(gravity: float, dtype, device) -> torch.Tensor:
    """[0, 0, gravity], filled on the device: a tensor built from a list, or
    an item assignment, would copy from the host, which a CUDA graph
    capture refuses."""
    return torch.cat([torch.zeros(2, dtype=dtype, device=device),
                      torch.full((1,), gravity, dtype=dtype, device=device)])


def predict(start: NavState, p: Preintegration, gravity: float = GRAVITY) -> NavState:
    """Propagate a NavState through the preintegrated delta (cpp:83-95)."""
    g = gravity_vector(gravity, start.p.dtype, start.p.device)
    R = start.R @ p.dR
    v = mv(start.R, p.dv) + start.v - g * p.dt
    pos = mv(start.R, p.dp) + start.p + start.v * p.dt - 0.5 * g * p.dt * p.dt
    return NavState(t=start.t + p.dt, R=R, p=pos, v=v, bg=p.bg, ba=p.ba)
