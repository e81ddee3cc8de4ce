"""Reader/writer for the rgbd360 raw spherical-frame ``.bin`` files.

A copy of rgbd360_tpu/io/boost_archive.py (the port imports nothing of the
JAX package); numpy only, the device never sees the wire format.

The reference serializes each omnidirectional capture as a Boost *binary*
archive containing 17 OpenCV matrices: 8x (RGB uint8 HxWx3 + depth uint16 HxW)
followed by a timestamp matrix (reference include/Frame360.h:333-345, wire
format of each cv::Mat in
OpenNI2_Grabber/third_party/cvSerialization/cvmat_serialization.h:23-55).

Wire layout (little-endian, non-portable Boost binary archive, as produced on
x86-64 Linux; verified byte-for-byte against samples/sphere_images_1.bin):

  u64   22                          length of the signature string
  22s   "serialization::archive"
  u16   9                           boost archive library version
  4B    04 08 04 08                 sizeof(int), long, float, double
  9B    01 00..00                   class metadata emitted once for cv::Mat
  17x mat records, each:
      i32  cols
      i32  rows
      u64  elem_size                bytes per element (3, 2, ...)
      u64  elem_type                cv type id (16=CV_8UC3, 2=CV_16UC1)
      raw  cols*rows*elem_size bytes, row-major

The bundled samples carry an *empty* (0x0) timestamp matrix.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

ARCHIVE_SIGNATURE = b"serialization::archive"
ARCHIVE_VERSION = 9
# sizeof(int), sizeof(long), sizeof(float), sizeof(double) on LP64
ARCHIVE_SIZES = bytes([4, 8, 4, 8])
# Class metadata blob Boost emits before the first cv::Mat record
CLASS_METADATA = b"\x01" + b"\x00" * 8

CV_8U, CV_8S, CV_16U, CV_16S, CV_32S, CV_32F, CV_64F = range(7)


def _cv_type(depth: int, channels: int) -> int:
    return depth + ((channels - 1) << 3)


_DTYPE_OF_DEPTH = {
    CV_8U: np.uint8,
    CV_8S: np.int8,
    CV_16U: np.uint16,
    CV_16S: np.int16,
    CV_32S: np.int32,
    CV_32F: np.float32,
    CV_64F: np.float64,
}
_DEPTH_OF_DTYPE = {np.dtype(v): k for k, v in _DTYPE_OF_DEPTH.items()}


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError(f"truncated archive: wanted {n} bytes at {self.pos}")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack("<" + fmt, self.take(size))


def _read_mat(cur: _Cursor) -> np.ndarray:
    cols, rows = cur.unpack("ii")
    (elem_size,) = cur.unpack("Q")
    (elem_type,) = cur.unpack("Q")
    depth = elem_type & 7
    channels = (elem_type >> 3) + 1
    dtype = np.dtype(_DTYPE_OF_DEPTH[depth])
    nbytes = cols * rows * elem_size
    raw = cur.take(nbytes)
    if rows == 0 or cols == 0:
        return np.zeros((rows, cols, channels) if channels > 1 else (rows, cols), dtype)
    arr = np.frombuffer(raw, dtype=dtype)
    if channels > 1:
        return arr.reshape(rows, cols, channels)
    return arr.reshape(rows, cols)


def _write_mat(out: bytearray, mat: np.ndarray) -> None:
    if mat.ndim == 2:
        rows, cols = mat.shape
        channels = 1
    elif mat.ndim == 3:
        rows, cols, channels = mat.shape
    else:
        raise ValueError(f"mat must be 2D or 3D, got shape {mat.shape}")
    depth = _DEPTH_OF_DTYPE[np.dtype(mat.dtype)]
    elem_type = _cv_type(depth, channels)
    elem_size = mat.dtype.itemsize * channels
    out += struct.pack("<iiQQ", cols, rows, elem_size, elem_type)
    out += np.ascontiguousarray(mat).tobytes()


@dataclasses.dataclass
class RawFrame360:
    """The raw 8-sensor capture as stored on disk.

    rgb:   (8, H, W, 3) uint8, channel order as stored by OpenCV (BGR)
    depth: (8, H, W) uint16, millimetres
    timestamp: uint64 device timestamp (0 if the file carried an empty matrix)
    """

    rgb: np.ndarray
    depth: np.ndarray
    timestamp: int = 0

    @property
    def num_sensors(self) -> int:
        return self.rgb.shape[0]


def read_frame360_bin(path: str) -> RawFrame360:
    """Load a raw spherical capture (reference include/Frame360.h:231-266)."""
    with open(path, "rb") as f:
        cur = _Cursor(f.read())

    (sig_len,) = cur.unpack("Q")
    sig = cur.take(sig_len)
    if sig != ARCHIVE_SIGNATURE:
        raise ValueError(f"not a boost binary archive: signature {sig!r}")
    (version,) = cur.unpack("H")
    if version >= 3:  # modern archives carry the primitive-size block
        cur.take(4)
    cur.take(len(CLASS_METADATA))  # one-time class metadata for cv::Mat

    rgbs, depths = [], []
    for _ in range(8):
        rgbs.append(_read_mat(cur))
        depths.append(_read_mat(cur))
    ts_mat = _read_mat(cur)

    timestamp = 0
    flat = np.ravel(ts_mat)
    if flat.size:
        # a 1 x num_digits CV_8U matrix of decimal digits, most significant
        # first (OpenNI2_Grabber/FrameRGBD/SerializeFrameRGBD.h:46-88)
        for digit in flat.astype(np.uint64):
            timestamp = timestamp * 10 + int(digit)

    return RawFrame360(rgb=np.stack(rgbs), depth=np.stack(depths), timestamp=timestamp)


def write_frame360_bin(path: str, frame: RawFrame360) -> None:
    """Serialize a RawFrame360 byte-compatibly with the reference writer
    (reference include/Frame360.h:333-345)."""
    # the wire format is fixed 8-sensor (reader and reference loader both
    # hardcode 8 mat pairs); refusing here beats writing an unreadable file
    assert frame.num_sensors == 8, f"wire format is 8-sensor, got {frame.num_sensors}"
    out = bytearray()
    out += struct.pack("<Q", len(ARCHIVE_SIGNATURE))
    out += ARCHIVE_SIGNATURE
    out += struct.pack("<H", ARCHIVE_VERSION)
    out += ARCHIVE_SIZES
    out += CLASS_METADATA
    for sensor_id in range(frame.num_sensors):
        _write_mat(out, frame.rgb[sensor_id])
        _write_mat(out, frame.depth[sensor_id])
    if frame.timestamp > 0:
        # 1 x num_digits CV_8U decimal-digit matrix (SerializeFrameRGBD.h:46-74)
        digits = np.frombuffer(
            str(int(frame.timestamp)).encode(), np.uint8
        ) - ord("0")
        _write_mat(out, digits.reshape(1, -1))
    else:
        # the bundled samples store an empty 0x0 matrix whose header is all
        # zeros (elem_size=0, elem_type=0) — match it byte-for-byte
        out += struct.pack("<iiQQ", 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(bytes(out))
