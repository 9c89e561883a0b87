"""ctypes bindings for the rivbin native runtime (see rivbin.cpp): a copy of
``rivslam_tpu/runtime/native.py`` for the port, which has no jax in it.

The shared library is compiled with g++ on first use into the gitignored
``rivslam_tpu_torch/_build/``, named by a hash of the source and the flags:
the compiler call has a timeout, writes a temporary file that is renamed
into place (a concurrent or interrupted build never leaves a partial
library behind, and no lock is needed), and a changed source is never
served a stale library. API mirrors the C functions; `NativeSequence` /
`PrefetchLoader` wrap them pythonically and hand fixed-shape numpy buffers
to the engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "rivbin.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_TIMEOUT_S = 300

_lib = None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librivbin_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True, capture_output=True,
                   timeout=BUILD_TIMEOUT_S)
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.rivbin_open.restype = c.c_void_p
    lib.rivbin_open.argtypes = [c.c_char_p]
    lib.rivbin_close.argtypes = [c.c_void_p]
    lib.rivbin_num_frames.restype = c.c_int64
    lib.rivbin_num_frames.argtypes = [c.c_void_p]
    lib.rivbin_num_imu.restype = c.c_int64
    lib.rivbin_num_imu.argtypes = [c.c_void_p]
    lib.rivbin_frame_stamp.restype = c.c_double
    lib.rivbin_frame_stamp.argtypes = [c.c_void_p, c.c_int64]
    lib.rivbin_frame_count.restype = c.c_int64
    lib.rivbin_frame_count.argtypes = [c.c_void_p, c.c_int64]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rivbin_read_frame.argtypes = [c.c_void_p, c.c_int64, c.c_int64, f32p, f32p, f32p, u8p]
    lib.rivbin_imu_between.restype = c.c_int64
    lib.rivbin_imu_between.argtypes = [c.c_void_p, c.c_double, c.c_double, c.c_int64, f64p, f32p, f32p]
    lib.rivbin_write.restype = c.c_int
    lib.rivbin_write.argtypes = [
        c.c_char_p, c.c_int64, f64p, i64p, f32p, f32p, f32p, c.c_int64, f64p, f32p, f32p,
    ]
    lib.rivbin_write_lz4.restype = c.c_int
    lib.rivbin_write_lz4.argtypes = lib.rivbin_write.argtypes
    lib.rivbin_format_version.restype = c.c_int64
    lib.rivbin_format_version.argtypes = [c.c_void_p]
    lib.rivbin_corrupt_frame.restype = c.c_int64
    lib.rivbin_corrupt_frame.argtypes = [c.c_void_p]
    lib.rivbin_tum_ate.restype = c.c_int
    lib.rivbin_tum_ate.argtypes = [
        c.c_char_p, c.c_char_p, c.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    u8buf = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rivbin_lz4_compress.restype = c.c_int64
    lib.rivbin_lz4_compress.argtypes = [u8buf, c.c_int64, u8buf, c.c_int64]
    lib.rivbin_lz4_decompress.restype = c.c_int64
    lib.rivbin_lz4_decompress.argtypes = [u8buf, c.c_int64, u8buf, c.c_int64]
    lib.rivbin_loader_create.restype = c.c_void_p
    lib.rivbin_loader_create.argtypes = [c.c_void_p, c.c_int64, c.c_int, c.c_int]
    lib.rivbin_loader_next.restype = c.c_int64
    lib.rivbin_loader_next.argtypes = [c.c_void_p, f32p, f32p, f32p, u8p, f64p]
    lib.rivbin_loader_next_aligned.restype = c.c_int64
    lib.rivbin_loader_next_aligned.argtypes = [
        c.c_void_p, f32p, f32p, f32p, u8p, f64p,
        c.c_int64, f64p, f32p, f32p, u8p, i64p,
    ]
    lib.rivbin_loader_destroy.argtypes = [c.c_void_p]
    _lib = lib
    return lib


def lz4_block_compress(data: bytes) -> bytes:
    """Compress one LZ4 block with the native codec (testing/interop)."""
    lib = get_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(len(data) + len(data) // 255 + 16, dtype=np.uint8)
    n = lib.rivbin_lz4_compress(src, len(src), dst, len(dst))
    if n < 0:
        raise ValueError("lz4 compress: destination too small")
    return dst[:n].tobytes()


def lz4_block_decompress(data: bytes, max_size: int) -> bytes:
    """Decompress one LZ4 block with the native codec. ``max_size`` is the
    output capacity (the LZ4 frame format stores only a per-frame block-size
    bound, not exact sizes); returns the actual decompressed bytes."""
    lib = get_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max(max_size, 1), dtype=np.uint8)
    n = lib.rivbin_lz4_decompress(src, len(src), dst, max_size)
    if n == 0 and len(data) > 1:
        raise ValueError("lz4 decompress: corrupt block or capacity exceeded")
    return dst[:n].tobytes()


def tum_ate(est_path: str, gt_path: str, max_dt: float = 0.05) -> dict:
    """Native ATE: TUM parse -> nearest-stamp association -> Horn SE(3)
    alignment -> error stats, all in C++ (the rpg-style protocol of
    eval/ate.py for scoring outside the Python process)."""
    lib = get_lib()
    out = np.zeros(6, dtype=np.float64)
    rc = lib.rivbin_tum_ate(est_path.encode(), gt_path.encode(), max_dt, out)
    if rc != 0:
        reason = {-1: f"cannot read {est_path}", -2: f"cannot read {gt_path}",
                  -3: "fewer than 3 associated pairs"}.get(rc, f"error {rc}")
        raise ValueError(f"tum_ate: {reason}")
    return {
        "pairs": int(out[0]), "rmse": float(out[1]), "mean": float(out[2]),
        "median": float(out[3]), "max": float(out[4]), "std": float(out[5]),
    }


def write_rivbin(path: str, seq, compress: bool = False) -> None:
    """Serialize an io.datasets.RadarSequence to the native container.

    ``compress=True`` writes the version-2 container with per-frame
    LZ4-block-compressed target chunks (decoded on the prefetch workers,
    the chunked-compression role of the reference's rosbags)."""
    lib = get_lib()
    writer = lib.rivbin_write_lz4 if compress else lib.rivbin_write
    rc = writer(
        path.encode(),
        seq.num_frames,
        np.ascontiguousarray(seq.frame_stamps, dtype=np.float64),
        np.ascontiguousarray(seq.offsets, dtype=np.int64),
        np.ascontiguousarray(seq.xyz, dtype=np.float32),
        np.ascontiguousarray(seq.doppler, dtype=np.float32),
        np.ascontiguousarray(seq.intensity, dtype=np.float32),
        len(seq.imu_stamps),
        np.ascontiguousarray(seq.imu_stamps, dtype=np.float64),
        np.ascontiguousarray(seq.imu_acc, dtype=np.float32),
        np.ascontiguousarray(seq.imu_gyr, dtype=np.float32),
    )
    if rc != 0:
        raise IOError(f"rivbin_write failed: {rc}")


class NativeSequence:
    """mmap-backed reader."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.rivbin_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open rivbin file {path}")

    def close(self):
        if self._h:
            self._lib.rivbin_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def num_frames(self) -> int:
        return self._lib.rivbin_num_frames(self._h)

    @property
    def format_version(self) -> int:
        """1 = raw mmap container, 2 = LZ4-chunked."""
        return self._lib.rivbin_format_version(self._h)

    def frame_stamp(self, i: int) -> float:
        return self._lib.rivbin_frame_stamp(self._h, i)

    def frame_count(self, i: int) -> int:
        return self._lib.rivbin_frame_count(self._h, i)

    def read_frame(self, i: int, capacity: int):
        xyz = np.empty((capacity, 3), dtype=np.float32)
        dop = np.empty(capacity, dtype=np.float32)
        inten = np.empty(capacity, dtype=np.float32)
        mask = np.empty(capacity, dtype=np.uint8)
        self._lib.rivbin_read_frame(self._h, i, capacity, xyz, dop, inten, mask)
        self._check_corrupt()
        return xyz, dop, inten, mask.astype(bool)

    def _check_corrupt(self):
        bad = self._lib.rivbin_corrupt_frame(self._h)
        if bad >= 0:
            raise IOError(
                f"rivbin: LZ4 chunk of frame {bad} failed to decode "
                "(corrupt or truncated container)"
            )

    def imu_between(self, t0: float, t1: float, capacity: int):
        stamps = np.zeros(capacity, dtype=np.float64)
        acc = np.zeros((capacity, 3), dtype=np.float32)
        gyr = np.zeros((capacity, 3), dtype=np.float32)
        k = self._lib.rivbin_imu_between(self._h, t0, t1, capacity, stamps, acc, gyr)
        return int(k), stamps, acc, gyr


class PrefetchLoader:
    """Background-threaded in-order frame loader (double buffering+)."""

    def __init__(self, seq: NativeSequence, capacity: int, threads: int = 2, max_queue: int = 8):
        self._lib = get_lib()
        self._seq = seq
        self.capacity = capacity
        self._h = self._lib.rivbin_loader_create(seq._h, capacity, threads, max_queue)

    def __iter__(self):
        return self

    def __next__(self):
        xyz = np.empty((self.capacity, 3), dtype=np.float32)
        dop = np.empty(self.capacity, dtype=np.float32)
        inten = np.empty(self.capacity, dtype=np.float32)
        mask = np.empty(self.capacity, dtype=np.uint8)
        stamp = np.zeros(1, dtype=np.float64)
        idx = self._lib.rivbin_loader_next(self._h, xyz, dop, inten, mask, stamp)
        if idx < 0:
            raise StopIteration
        self._seq._check_corrupt()
        return int(idx), float(stamp[0]), xyz, dop, inten, mask.astype(bool)

    def next_aligned(self, imu_capacity: int):
        """Next frame + its natively-aligned IMU window.

        Returns (idx, stamp, xyz, dop, inten, mask, imu_dts, imu_acc,
        imu_gyr, imu_mask) — exactly the per-frame inputs of
        Engine.process_frame — or None at end of sequence. The dt clamp
        [1e-4, 0.05] matches io/datasets.imu_between.
        """
        xyz = np.empty((self.capacity, 3), dtype=np.float32)
        dop = np.empty(self.capacity, dtype=np.float32)
        inten = np.empty(self.capacity, dtype=np.float32)
        mask = np.empty(self.capacity, dtype=np.uint8)
        stamp = np.zeros(1, dtype=np.float64)
        dts = np.zeros(imu_capacity, dtype=np.float64)
        acc = np.zeros((imu_capacity, 3), dtype=np.float32)
        gyr = np.zeros((imu_capacity, 3), dtype=np.float32)
        imask = np.zeros(imu_capacity, dtype=np.uint8)
        count = np.zeros(1, dtype=np.int64)
        idx = self._lib.rivbin_loader_next_aligned(
            self._h, xyz, dop, inten, mask, stamp,
            imu_capacity, dts, acc, gyr, imask, count,
        )
        if idx < 0:
            return None
        self._seq._check_corrupt()
        return (int(idx), float(stamp[0]), xyz, dop, inten,
                mask.astype(bool), dts, acc, gyr, imask.astype(bool))

    def close(self):
        if self._h:
            self._lib.rivbin_loader_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
