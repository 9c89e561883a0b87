"""Radar sequence container and the offline replay loop (numpy-only port
of the parts of ``rivslam_tpu/io/datasets.py`` the per-frame engine needs).

``RadarSequence`` holds ragged per-frame targets (CSR offsets), the IMU
stream, optional ground truth, barometer and GPS streams, and reads and
writes the same ``.npz`` container as the reference. ``replay`` feeds a
sequence through an Engine frame by frame, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rivslam_tpu_torch.core.pointcloud import RadarCloud


@dataclasses.dataclass
class RadarSequence:
    """Ragged radar sequence + IMU stream + optional ground truth."""

    frame_stamps: np.ndarray  # [F]
    offsets: np.ndarray  # [F+1] CSR offsets into target arrays
    xyz: np.ndarray  # [T, 3]
    doppler: np.ndarray  # [T]
    intensity: np.ndarray  # [T]
    imu_stamps: np.ndarray  # [M]
    imu_acc: np.ndarray  # [M, 3]
    imu_gyr: np.ndarray  # [M, 3]
    gt_stamps: np.ndarray | None = None  # [G]
    gt_poses: np.ndarray | None = None  # [G, 4, 4]
    baro_stamps: np.ndarray | None = None  # [B] barometer stream (Barometer.msg)
    baro_alt: np.ndarray | None = None  # [B] altitude
    gps_stamps: np.ndarray | None = None  # [G] GPS fixes (NavSatFix, cov-gated)
    gps_utm: np.ndarray | None = None  # [G,3] UTM (easting, northing, altitude)
    gps_cov: np.ndarray | None = None  # [G,3] diag position covariance (m^2)

    @property
    def num_frames(self) -> int:
        return len(self.frame_stamps)

    def frame(self, i: int) -> dict:
        s, e = self.offsets[i], self.offsets[i + 1]
        return dict(
            stamp=float(self.frame_stamps[i]),
            xyz=self.xyz[s:e],
            doppler=self.doppler[s:e],
            intensity=self.intensity[s:e],
        )

    def baro_at(self, t: float, max_gap: float = 1.0) -> float | None:
        """Nearest barometer altitude within max_gap seconds of t (the
        reference pairs each keyframe with the latest Barometer message)."""
        if self.baro_stamps is None or len(self.baro_stamps) == 0:
            return None
        i = int(np.argmin(np.abs(self.baro_stamps - t)))
        if abs(float(self.baro_stamps[i]) - t) > max_gap:
            return None
        return float(self.baro_alt[i])

    def gps_at(self, t: float, max_gap: float = 0.2):
        """Nearest covariance-gated GPS fix within max_gap seconds of t:
        (utm [3], cov_diag [3]) or (None, None). Mirrors the reference's
        stamp association tolerance (gps_traj_align.cpp associate max_dt)."""
        if self.gps_stamps is None or len(self.gps_stamps) == 0:
            return None, None
        i = int(np.argmin(np.abs(self.gps_stamps - t)))
        if abs(float(self.gps_stamps[i]) - t) > max_gap:
            return None, None
        cov = self.gps_cov[i] if self.gps_cov is not None else None
        return self.gps_utm[i], cov

    def imu_between(self, t0: float, t1: float, capacity: int):
        """Masked fixed-capacity IMU batch in (t0, t1], with per-sample dt
        (clamped like the reference, nodelet:355-362)."""
        sel = (self.imu_stamps > t0) & (self.imu_stamps <= t1)
        idx = np.where(sel)[0][:capacity]
        k = len(idx)
        dts = np.zeros(capacity)
        acc = np.zeros((capacity, 3))
        gyr = np.zeros((capacity, 3))
        m = np.zeros(capacity, dtype=bool)
        if k:
            stamps = self.imu_stamps[idx]
            d = np.diff(np.concatenate([[t0], stamps]))
            # sanity clamp; the reference forces dt>0.01 -> 0.005 (tuned for
            # its 400 Hz IMU, nodelet:357-362) — we clamp to a 20 Hz floor so
            # lower-rate IMUs integrate correctly
            d = np.clip(d, 1e-4, 0.05)
            dts[:k] = d
            acc[:k] = self.imu_acc[idx]
            gyr[:k] = self.imu_gyr[idx]
            m[:k] = True
        return dts, acc, gyr, m

    def save(self, path: str) -> None:
        data = dict(
            frame_stamps=self.frame_stamps,
            offsets=self.offsets,
            xyz=self.xyz,
            doppler=self.doppler,
            intensity=self.intensity,
            imu_stamps=self.imu_stamps,
            imu_acc=self.imu_acc,
            imu_gyr=self.imu_gyr,
        )
        if self.gt_stamps is not None:
            data["gt_stamps"] = self.gt_stamps
            data["gt_poses"] = self.gt_poses
        if self.baro_stamps is not None:
            data["baro_stamps"] = self.baro_stamps
            data["baro_alt"] = self.baro_alt
        if self.gps_stamps is not None:
            data["gps_stamps"] = self.gps_stamps
            data["gps_utm"] = self.gps_utm
            if self.gps_cov is not None:
                data["gps_cov"] = self.gps_cov
        np.savez_compressed(path, **data)

    @staticmethod
    def load(path: str) -> "RadarSequence":
        d = np.load(path)
        return RadarSequence(
            frame_stamps=d["frame_stamps"],
            offsets=d["offsets"],
            xyz=d["xyz"],
            doppler=d["doppler"],
            intensity=d["intensity"],
            imu_stamps=d["imu_stamps"],
            imu_acc=d["imu_acc"],
            imu_gyr=d["imu_gyr"],
            gt_stamps=d["gt_stamps"] if "gt_stamps" in d else None,
            gt_poses=d["gt_poses"] if "gt_poses" in d else None,
            baro_stamps=d["baro_stamps"] if "baro_stamps" in d else None,
            baro_alt=d["baro_alt"] if "baro_alt" in d else None,
            gps_stamps=d["gps_stamps"] if "gps_stamps" in d else None,
            gps_utm=d["gps_utm"] if "gps_utm" in d else None,
            gps_cov=d["gps_cov"] if "gps_cov" in d else None,
        )

    @staticmethod
    def from_frames(frames: list[dict], imu_stamps, imu_acc, imu_gyr, gt=None) -> "RadarSequence":
        offsets = np.zeros(len(frames) + 1, dtype=np.int64)
        for i, f in enumerate(frames):
            offsets[i + 1] = offsets[i] + len(f["xyz"])
        return RadarSequence(
            frame_stamps=np.asarray([f["stamp"] for f in frames]),
            offsets=offsets,
            xyz=np.concatenate([f["xyz"] for f in frames]) if frames else np.zeros((0, 3)),
            doppler=np.concatenate([f["doppler"] for f in frames]) if frames else np.zeros(0),
            intensity=np.concatenate([f["intensity"] for f in frames]) if frames else np.zeros(0),
            imu_stamps=np.asarray(imu_stamps),
            imu_acc=np.asarray(imu_acc),
            imu_gyr=np.asarray(imu_gyr),
            gt_stamps=gt[0] if gt else None,
            gt_poses=gt[1] if gt else None,
        )


def replay(engine, seq: RadarSequence, capacity: int = 1024, imu_capacity: int = 64, progress=None):
    """Deterministic offline replay of a sequence through an Engine."""
    outputs = []
    prev_t = None
    for i in range(seq.num_frames):
        f = seq.frame(i)
        cloud = RadarCloud.from_numpy(
            f["xyz"], capacity, doppler=f["doppler"], intensity=f["intensity"],
            dtype=engine.dtype, device=engine.device,
        )
        t0 = prev_t if prev_t is not None else f["stamp"] - 0.1
        dts, acc, gyr, m = seq.imu_between(t0, f["stamp"], imu_capacity)
        gps_utm, gps_cov = seq.gps_at(
            f["stamp"], max_gap=engine.cfg.gps.max_association_dt
        )
        out = engine.process_frame(
            cloud, f["stamp"], dts, acc, gyr, m,
            altitude=seq.baro_at(f["stamp"]),
            gps_utm=gps_utm, gps_cov=gps_cov,
        )
        outputs.append(out)
        prev_t = f["stamp"]
        if progress is not None:
            progress(i, seq.num_frames)
    engine.finalize()
    return outputs
