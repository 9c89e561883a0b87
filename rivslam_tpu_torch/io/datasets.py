"""Dataset containers, radar format shims and the offline replay driver
(numpy-only port of ``rivslam_tpu/io/datasets.py``).

- The radar formats' frame converters (preprocessing_nodelet.cpp:66-80):
  Oculii Eagle (PointCloud + Doppler/Power channels), Sensrad Hugin
  (PointCloud2 fields) and RadarScanExtended (spherical targets, z negated
  as the reference does, cloud_callback_scan:334-336).
- ``RadarSequence`` holds ragged per-frame targets (CSR offsets), the IMU
  stream, optional ground truth, barometer and GPS streams, and reads and
  writes the same ``.npz`` container as the reference; ``convert_rosbag``
  converts a ROS1 bag into it (``io/rosbag1.py`` without ROS).
- ``stack_sequence`` / ``stack_native_sequence`` pad a whole sequence into
  fixed-shape [F, ...] arrays; ``replay`` feeds a sequence through an Engine
  frame by frame, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rivslam_tpu_torch.core.pointcloud import RadarCloud


# ---------------------------------------------------------------------------
# format shims
# ---------------------------------------------------------------------------


def targets_to_xyz(range_, azimuth, elevation):
    """RadarScanExtended spherical targets -> cartesian, reproducing the
    reference's sign convention (z NEGATED, cloud_callback_scan:334-336)."""
    x = range_ * np.cos(elevation) * np.cos(azimuth)
    y = range_ * np.cos(elevation) * np.sin(azimuth)
    z = -range_ * np.sin(elevation)
    return np.stack([x, y, z], axis=-1)


def eagle_channels_to_frame(points_xyz, doppler, power):
    """Oculii Eagle sensor_msgs/PointCloud layout: xyz points + Doppler and
    Power channels (preprocessing cloud_callback)."""
    return dict(xyz=np.asarray(points_xyz), doppler=np.asarray(doppler), intensity=np.asarray(power))


def hugin_fields_to_frame(x, y, z, v, power):
    """Sensrad Hugin PointCloud2 field layout (HuginPointCloudType,
    rio_utils/radar_point_cloud.h)."""
    return dict(
        xyz=np.stack([x, y, z], axis=-1), doppler=np.asarray(v), intensity=np.asarray(power)
    )



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


def convert_rosbag(
    bag_path: str,
    out_path: str,
    radar_topic: str = "/radar_enhanced_pcl",
    imu_topic: str = "/vectornav/imu",
    radar_format: str = "eagle",
) -> None:
    """NTU4DRadLM / MineAndForest rosbag -> rivseq conversion. Requires the
    `rosbag` package (run on a ROS host; this image has no ROS)."""
    try:
        import rosbag  # type: ignore
    except ImportError:
        # pure-python fallback reader (io/rosbag1.py) — no ROS needed
        from rivslam_tpu_torch.io import rosbag1

        rosbag1.convert_bag(bag_path, out_path, radar_topic, imu_topic)
        return
    frames, imu_t, imu_a, imu_g = [], [], [], []
    with rosbag.Bag(bag_path) as bag:  # pragma: no cover
        for topic, msg, t in bag.read_messages(topics=[radar_topic, imu_topic]):
            if topic == imu_topic:
                imu_t.append(msg.header.stamp.to_sec())
                imu_a.append([msg.linear_acceleration.x, msg.linear_acceleration.y, msg.linear_acceleration.z])
                imu_g.append([msg.angular_velocity.x, msg.angular_velocity.y, msg.angular_velocity.z])
            else:
                if radar_format == "eagle":
                    xyz = np.asarray([[p.x, p.y, p.z] for p in msg.points])
                    ch = {c.name: np.asarray(c.values) for c in msg.channels}
                    f = eagle_channels_to_frame(
                        xyz, ch.get("Doppler", np.zeros(len(xyz))), ch.get("Power", np.zeros(len(xyz)))
                    )
                elif radar_format == "scan_extended":
                    rng_ = np.asarray([tg.range for tg in msg.targets])
                    az = np.asarray([tg.azimuth for tg in msg.targets])
                    el = np.asarray([tg.elevation for tg in msg.targets])
                    f = dict(
                        xyz=targets_to_xyz(rng_, az, el),
                        doppler=np.asarray([tg.velocity for tg in msg.targets]),
                        intensity=np.asarray([tg.snr for tg in msg.targets]),
                    )
                else:
                    raise ValueError(radar_format)
                f["stamp"] = msg.header.stamp.to_sec()
                frames.append(f)
    seq = RadarSequence.from_frames(frames, imu_t, imu_a, imu_g)
    seq.save(out_path)


# ---------------------------------------------------------------------------
# replay driver (bag_player equivalent)
# ---------------------------------------------------------------------------


def stack_sequence(seq: RadarSequence, capacity: int = 1024,
                   imu_capacity: int = 64) -> dict:
    """Stack a whole sequence into fixed-shape [F, ...] arrays — the input
    format of `Engine.replay_sequence` (device-resident whole-sequence scan).
    Per-frame padding and the IMU window/dt-clamp match `replay` exactly."""
    F = seq.num_frames
    xyz = np.zeros((F, capacity, 3), np.float32)
    dop = np.zeros((F, capacity), np.float32)
    inten = np.zeros((F, capacity), np.float32)
    mask = np.zeros((F, capacity), bool)
    stamps = np.zeros(F, np.float64)
    dts = np.zeros((F, imu_capacity), np.float64)
    # f64: the engine applies IMU extrinsics BEFORE the working-dtype cast
    # (pipeline.process_frame); stacking must not round first or
    # replay_sequence loses bit-parity with the host driver
    acc = np.zeros((F, imu_capacity, 3), np.float64)
    gyr = np.zeros((F, imu_capacity, 3), np.float64)
    imask = np.zeros((F, imu_capacity), bool)
    prev_t = None
    for i in range(F):
        f = seq.frame(i)
        n = min(len(f["xyz"]), capacity)
        xyz[i, :n] = f["xyz"][:n]
        dop[i, :n] = f["doppler"][:n]
        inten[i, :n] = f["intensity"][:n]
        mask[i, :n] = True
        stamps[i] = f["stamp"]
        t0 = prev_t if prev_t is not None else f["stamp"] - 0.1
        dts[i], acc[i], gyr[i], imask[i] = seq.imu_between(
            t0, f["stamp"], imu_capacity
        )
        prev_t = f["stamp"]
    return dict(xyz=xyz, doppler=dop, intensity=inten, mask=mask,
                stamps=stamps, imu_dts=dts, imu_acc=acc, imu_gyr=gyr,
                imu_mask=imask)


def stack_native_sequence(ns, capacity: int = 1024,
                          imu_capacity: int = 64) -> dict:
    """`stack_sequence` for a runtime.native.NativeSequence (.rivbin).
    Same padding, (t0, t] IMU window, t-0.1 first-frame convention, and
    [1e-4, 0.05] dt clamp as the Python path."""
    F = ns.num_frames
    out = dict(
        xyz=np.zeros((F, capacity, 3), np.float32),
        doppler=np.zeros((F, capacity), np.float32),
        intensity=np.zeros((F, capacity), np.float32),
        mask=np.zeros((F, capacity), bool),
        stamps=np.zeros(F, np.float64),
        imu_dts=np.zeros((F, imu_capacity), np.float64),
        imu_acc=np.zeros((F, imu_capacity, 3), np.float64),
        imu_gyr=np.zeros((F, imu_capacity, 3), np.float64),
        imu_mask=np.zeros((F, imu_capacity), bool),
    )
    prev_t = None
    for i in range(F):
        xyz, dop, inten, mask = ns.read_frame(i, capacity)
        t = ns.frame_stamp(i)
        out["xyz"][i], out["doppler"][i] = xyz, dop
        out["intensity"][i], out["mask"][i] = inten, mask
        out["stamps"][i] = t
        t0 = prev_t if prev_t is not None else t - 0.1
        k, st_, ac_, gy_ = ns.imu_between(t0, t, imu_capacity)
        if k:
            out["imu_dts"][i, :k] = np.diff(
                np.concatenate([[t0], st_[:k]])
            ).clip(1e-4, 0.05)
            out["imu_acc"][i, :k] = ac_[:k]
            out["imu_gyr"][i, :k] = gy_[:k]
            out["imu_mask"][i, :k] = True
        prev_t = t
    return out


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
