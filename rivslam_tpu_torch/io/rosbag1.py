"""Pure-Python ROS1 bag (format 2.0) reader — no ROS installation needed:
a copy of ``rivslam_tpu/io/rosbag1.py``, which has no jax in it.

Covers exactly what the NTU4DRadLM / MineAndForest ingestion requires
(preprocessing_nodelet.cpp:66-80):
- sensor_msgs/PointCloud  (Oculii Eagle: points + Doppler/Power channels)
- sensor_msgs/PointCloud2 (Sensrad Hugin: x,y,z,v,power fields)
- sensor_msgs/Imu
- msgs_radar/RadarScanExtended (SJTU format: spherical targets)

Bag format reference: http://wiki.ros.org/Bags/Format/2.0 — records with
header (name=value fields) + data; chunks hold message records and may be
'none' or 'bz2' compressed (lz4 needs the roslz4 lib, absent here — raise).
Message bodies are little-endian ROS serialization.
"""

from __future__ import annotations

import bz2
import struct

import numpy as np

_MSG_DATA = 0x02
_BAG_HEADER = 0x03
_INDEX_DATA = 0x04
_CHUNK = 0x05
_CHUNK_INFO = 0x06
_CONNECTION = 0x07


def _read_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(data: bytes):
    """Yield (header_fields, record_data) from a byte stream."""
    off = 0
    n = len(data)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        hdr = _read_header(data[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", data, off)
        off += 4
        body = data[off : off + dlen]
        off += dlen
        yield hdr, body


class RosTime:
    __slots__ = ("sec", "nsec")

    def __init__(self, sec, nsec):
        self.sec, self.nsec = sec, nsec

    def to_sec(self) -> float:
        return self.sec + self.nsec * 1e-9


class _Reader:
    """Cursor over a serialized ROS1 message body."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def f32(self):
        (v,) = struct.unpack_from("<f", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.off : self.off + n].decode(errors="replace")
        self.off += n
        return s

    def time(self):
        return RosTime(self.u32(), self.u32())

    def bytes_(self, n):
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def f32_array(self, n):
        a = np.frombuffer(self.buf, dtype="<f4", count=n, offset=self.off)
        self.off += 4 * n
        return a

    def f64_array(self, n):
        a = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return a

    def header(self):
        seq = self.u32()
        stamp = self.time()
        frame_id = self.string()
        return dict(seq=seq, stamp=stamp, frame_id=frame_id)


# ---------------------------------------------------------------------------
# message parsers (return dicts)
# ---------------------------------------------------------------------------


def parse_imu(body: bytes) -> dict:
    r = _Reader(body)
    h = r.header()
    orientation = [r.f64() for _ in range(4)]  # x y z w
    r.f64_array(9)
    ang = [r.f64() for _ in range(3)]
    r.f64_array(9)
    lin = [r.f64() for _ in range(3)]
    r.f64_array(9)
    return dict(header=h, orientation=orientation, angular_velocity=ang, linear_acceleration=lin)


def parse_barometer(body: bytes) -> dict:
    """radar_graph_slam/Barometer (msg/Barometer.msg: Header + altitude/
    pressure/temperature float32)."""
    r = _Reader(body)
    h = r.header()
    return dict(header=h, altitude=r.f32(), pressure=r.f32(), temperature=r.f32())


def parse_navsatfix(body: bytes) -> dict:
    """sensor_msgs/NavSatFix: header, NavSatStatus{int8 status, uint16
    service}, latitude/longitude/altitude (f64), position_covariance f64[9],
    position_covariance_type u8 (the GPS input of gps_traj_align.cpp:104 and
    the backend's enable_gps path)."""
    r = _Reader(body)
    h = r.header()
    status = r.i8()
    service = struct.unpack_from("<H", r.buf, r.off)[0]
    r.off += 2
    lat = r.f64()
    lon = r.f64()
    alt = r.f64()
    cov = r.f64_array(9)
    cov_type = r.u8()
    return dict(
        header=h, status=status, service=service, latitude=lat,
        longitude=lon, altitude=alt, position_covariance=cov,
        position_covariance_type=cov_type,
    )


def parse_pointcloud(body: bytes) -> dict:
    """sensor_msgs/PointCloud: header, points[], channels[] (Eagle layout)."""
    r = _Reader(body)
    h = r.header()
    n = r.u32()
    pts = np.frombuffer(r.bytes_(12 * n), dtype="<f4").reshape(n, 3)
    n_ch = r.u32()
    channels = {}
    for _ in range(n_ch):
        name = r.string()
        m = r.u32()
        channels[name] = r.f32_array(m)
    return dict(header=h, points=pts, channels=channels)


def parse_pointcloud2(body: bytes) -> dict:
    """sensor_msgs/PointCloud2 with named fields -> structured arrays."""
    r = _Reader(body)
    h = r.header()
    height = r.u32()
    width = r.u32()
    n_fields = r.u32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append((name, offset, datatype, count))
    is_bigendian = r.u8()
    point_step = r.u32()
    row_step = r.u32()
    n_data = r.u32()
    data = r.bytes_(n_data)
    n_pts = height * width
    _DT = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}
    out = {}
    raw = np.frombuffer(data, dtype=np.uint8, count=n_pts * point_step).reshape(
        n_pts, point_step
    )
    for name, offset, datatype, count in fields:
        dt = np.dtype("<" + _DT[datatype])
        col = raw[:, offset : offset + dt.itemsize * count].copy()
        out[name] = col.view(dt).reshape(n_pts, count).squeeze(-1)
    return dict(header=h, fields=out, width=width, height=height)


def parse_radar_scan_extended(body: bytes) -> dict:
    """msgs_radar/RadarScanExtended (msg/RadarTargetExtended.msg):
    each target = range, azimuth, elevation, velocity (+power, snr, rcs,
    confidence and per-field noise floats — all float32)."""
    r = _Reader(body)
    h = r.header()
    n = r.u32()
    targets = []
    for _ in range(n):
        # RadarTargetExtended: 16 float32 fields in declaration order:
        # range azimuth elevation velocity power snr rcs confidence +
        # rangeMse azimuthMse elevationMse velocityMse + 4 std fields
        vals = r.f32_array(16)
        targets.append(vals)
    targets = np.stack(targets) if targets else np.zeros((0, 16), np.float32)
    return dict(
        header=h,
        range=targets[:, 0],
        azimuth=targets[:, 1],
        elevation=targets[:, 2],
        velocity=targets[:, 3],
        power=targets[:, 4],
        snr=targets[:, 5],
    )


# ---------------------------------------------------------------------------
# bag reading
# ---------------------------------------------------------------------------


def read_messages(path: str, topics: list[str] | None = None):
    """Yield (topic, conn_type, stamp_sec, body bytes) for each message."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS1 v2.0 bag: {magic!r}")
        data = f.read()
    connections: dict[int, dict] = {}
    for hdr, body in _records(data):
        op = hdr.get("op", b"\x00")[0]
        if op == _CONNECTION:
            conn_id = struct.unpack("<I", hdr["conn"])[0]
            sub = _read_header(body)
            connections[conn_id] = dict(
                topic=hdr["topic"].decode(), type=sub.get("type", b"").decode()
            )
        elif op == _CHUNK:
            compression = hdr.get("compression", b"none").decode()
            if compression == "none":
                chunk = body
            elif compression == "bz2":
                chunk = bz2.decompress(body)
            elif compression == "lz4":
                # roslz4 writes the standard LZ4 Frame format (lz4s.c)
                from rivslam_tpu_torch.io import lz4f

                chunk = lz4f.decompress_frame(body)
            else:
                # bag format 2.0 defines none, bz2 and lz4 only: a malformed bag
                raise ValueError(
                    f"chunk compression '{compression}' unsupported"
                )
            for chdr, cbody in _records(chunk):
                cop = chdr.get("op", b"\x00")[0]
                if cop == _CONNECTION:
                    conn_id = struct.unpack("<I", chdr["conn"])[0]
                    sub = _read_header(cbody)
                    connections[conn_id] = dict(
                        topic=chdr["topic"].decode(), type=sub.get("type", b"").decode()
                    )
                elif cop == _MSG_DATA:
                    conn_id = struct.unpack("<I", chdr["conn"])[0]
                    conn = connections.get(conn_id, {})
                    topic = conn.get("topic", "")
                    if topics and topic not in topics:
                        continue
                    sec, nsec = struct.unpack("<II", chdr["time"])
                    yield topic, conn.get("type", ""), sec + nsec * 1e-9, cbody


def convert_bag(
    bag_path: str,
    out_path: str,
    radar_topic: str = "/radar_enhanced_pcl",
    imu_topic: str = "/vectornav/imu",
    baro_topic: str = "/barometer",
    gps_topic: str = "/ublox/fix",
    gps_max_cov_xx: float = 3.0,
    gps_max_cov_zz: float = 8.0,
):
    """NTU4DRadLM-style bag -> rivseq .npz, auto-detecting the radar format
    from the connection type (mirrors preprocessing_nodelet.cpp:66-80).
    NavSatFix fixes are covariance-gated and converted to UTM exactly like
    gps_traj_align.cpp:157-170 (skip if cov_xx > 3 or cov_zz > 8; keep
    (easting, northing, altitude) + diagonal covariance)."""
    from rivslam_tpu_torch.io import datasets, geo

    frames, imu_t, imu_a, imu_g = [], [], [], []
    baro_t, baro_a = [], []
    gps_t, gps_lla, gps_cov = [], [], []
    for topic, msg_type, stamp, body in read_messages(
        bag_path, topics=[radar_topic, imu_topic, baro_topic, gps_topic]
    ):
        if topic == baro_topic or msg_type.endswith("Barometer"):
            m = parse_barometer(body)
            baro_t.append(m["header"]["stamp"].to_sec())
            baro_a.append(m["altitude"])
            continue
        if topic == gps_topic or msg_type.endswith("NavSatFix"):
            m = parse_navsatfix(body)
            # no-fix messages (NavSatStatus STATUS_NO_FIX = -1) and
            # non-finite coordinates must never reach the graph: a NaN
            # lat/lon would poison zero_utm and every rel_utm after it
            if m["status"] < 0 or not all(
                np.isfinite(v)
                for v in (m["latitude"], m["longitude"], m["altitude"])
            ):
                continue
            c = m["position_covariance"]
            if m["position_covariance_type"] == 0:
                # COVARIANCE_TYPE_UNKNOWN: the all-zero matrix means
                # "unknown", not "perfect" — keep the fix but mark the
                # covariance NaN so downstream falls back to the
                # configured GpsConfig.stddev_xy/_z prior strengths
                gps_t.append(m["header"]["stamp"].to_sec())
                gps_lla.append((m["latitude"], m["longitude"], m["altitude"]))
                gps_cov.append((np.nan, np.nan, np.nan))
                continue
            # fix-quality gate (gps_traj_align.cpp:158-159)
            if c[0] > gps_max_cov_xx or c[8] > gps_max_cov_zz:
                continue
            gps_t.append(m["header"]["stamp"].to_sec())
            gps_lla.append((m["latitude"], m["longitude"], m["altitude"]))
            gps_cov.append((c[0], c[4], c[8]))
            continue
        if topic == imu_topic:
            m = parse_imu(body)
            imu_t.append(m["header"]["stamp"].to_sec())
            imu_a.append(m["linear_acceleration"])
            imu_g.append(m["angular_velocity"])
            continue
        if msg_type.endswith("PointCloud"):
            m = parse_pointcloud(body)
            dop = m["channels"].get("Doppler", np.zeros(len(m["points"])))
            power = m["channels"].get("Power", np.zeros(len(m["points"])))
            frames.append(dict(
                stamp=m["header"]["stamp"].to_sec(), xyz=np.asarray(m["points"], np.float64),
                doppler=np.asarray(dop, np.float64), intensity=np.asarray(power, np.float64),
            ))
        elif msg_type.endswith("PointCloud2"):
            m = parse_pointcloud2(body)
            f = m["fields"]
            xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float64)
            dop = f.get("v", f.get("doppler", np.zeros(len(xyz))))
            power = f.get("power", f.get("intensity", np.zeros(len(xyz))))
            frames.append(dict(
                stamp=m["header"]["stamp"].to_sec(), xyz=xyz,
                doppler=np.asarray(dop, np.float64), intensity=np.asarray(power, np.float64),
            ))
        elif msg_type.endswith("RadarScanExtended"):
            m = parse_radar_scan_extended(body)
            xyz = datasets.targets_to_xyz(m["range"], m["azimuth"], m["elevation"])
            frames.append(dict(
                stamp=m["header"]["stamp"].to_sec(), xyz=np.asarray(xyz, np.float64),
                doppler=np.asarray(m["velocity"], np.float64),
                intensity=np.asarray(m["snr"], np.float64),
            ))
    seq = datasets.RadarSequence.from_frames(frames, imu_t, imu_a, imu_g)
    if baro_t:
        seq.baro_stamps = np.asarray(baro_t)
        seq.baro_alt = np.asarray(baro_a)
    if gps_t:
        lla = np.asarray(gps_lla, np.float64)
        seq.gps_stamps = np.asarray(gps_t)
        seq.gps_utm = np.atleast_2d(
            geo.navsat_to_utm(lla[:, 0], lla[:, 1], lla[:, 2])
        )
        seq.gps_cov = np.asarray(gps_cov, np.float64)
    seq.save(out_path)
    return seq
