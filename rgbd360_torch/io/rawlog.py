"""Copy of rgbd360_tpu/io/rawlog.py (host numpy only: the port imports
nothing of the JAX package). cv2 stays a lazy import, used only for
JPEG/PNG CImage payloads.

MRPT rawlog reader/writer — the subset LoadRawlog consumes.

The reference's LoadRawlog (Visualization/LoadRawlog.cpp:94-231) opens a
gzipped MRPT rawlog and pulls CObservation3DRangeScan records tagged
RGBD1..RGBD4 (plus an ignored LASER scan). This module implements that
container natively:

* **Container framing** (exact MRPT CStream::WriteObject wire format): each
  object is `uint8 (len(classname) | 0x80)`, the classname bytes, an `int8`
  serialization version, the class payload, and a `0x88` end flag; a .rawlog
  file is a gzip stream of consecutive objects.
* **Payload layouts**: MRPT payloads carry no length prefix — a reader must
  understand every field to find the record boundary. The layouts below
  (CObservation3DRangeScan v2-v6, TCamera v0-2, CMatrix/CMatrixD, CImage
  v7-9, CPose3D v1/v2) follow the reference-era MRPT-1.x field order, reconstructed
  from the MRPT serialization spec: CObservation3DRangeScan streams
  maxRange, sensorPose, the points3D block, rangeImage, intensityImage and
  confidenceImage each behind a presence byte, then (v2+) cameraParams,
  (v4+) cameraParamsIntensity + relativePoseIntensityWRTDepth, stdError,
  timestamp, sensorLabel, (v3+) the external-storage flag/file pairs,
  (v5+) range_is_depth and (v6) the int8 intensityImageChannel. TCamera
  nests its 3x3 intrinsics as a CMatrixD object. JPEG/PNG-compressed
  CImage payloads are decoded via cv2. Stream versions whose layout is not
  implemented are refused by _guard_version (no length prefix = no safe
  skip), and any field-layout mismatch is caught loudly by the 0x88
  end-flag check. The READER is gated against an independently
  hand-assembled byte fixture (tests/golden/minimal_v6.rawlog, built by
  tests/make_rawlog_fixture.py without either package's writer) in
  addition to round-trips against the writers of both packages
  (tests/test_torch_rawlog.py). Outstanding: no archive written by real
  MRPT exists in this image (no sources, no egress), so byte-level fidelity
  against genuine MRPT output remains ungated — a real sample would close it.

Primitive encodings (MRPT CStream): little-endian scalars; strings are
`uint32 length` + raw bytes; timestamps are `uint64` (100 ns ticks).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

END_FLAG = 0x88
_NAME_LEN_MASK = 0x80


# ---------------------------------------------------------------------------
# primitive stream helpers
# ---------------------------------------------------------------------------


def _read(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated rawlog stream")
    return b


def _read_fmt(f: BinaryIO, fmt: str):
    return struct.unpack("<" + fmt, _read(f, struct.calcsize("<" + fmt)))


def _write_fmt(f: BinaryIO, fmt: str, *vals) -> None:
    f.write(struct.pack("<" + fmt, *vals))


def _read_string(f: BinaryIO) -> str:
    (n,) = _read_fmt(f, "I")
    if n > 1 << 20:
        raise ValueError(f"implausible string length {n} — corrupt stream")
    return _read(f, n).decode("latin-1")


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode("latin-1")
    _write_fmt(f, "I", len(b))
    f.write(b)


def _read_header(f: BinaryIO):
    """Object header: (classname, version). Returns None at clean EOF."""
    lead = f.read(1)
    if not lead:
        return None
    n = lead[0]
    if not n & _NAME_LEN_MASK:
        raise ValueError(f"bad object header byte 0x{n:02x} (expected 0x80 flag)")
    name = _read(f, n & ~_NAME_LEN_MASK).decode("ascii")
    (version,) = _read_fmt(f, "b")
    return name, version


def _read_header_required(f: BinaryIO, context: str):
    """Header of a NESTED object (CPose3D/CMatrix/CImage/TCamera inside an
    observation). Unlike the top-level loop — where an empty read at an
    object boundary is the clean end of the stream — a missing header here
    means the stream was cut mid-object: raise like every other truncation
    (EOFError, converted to ValueError by read_rawlog) instead of letting
    the None unpack escape as TypeError."""
    header = _read_header(f)
    if header is None:
        raise EOFError(f"truncated rawlog stream (EOF where {context} expected)")
    return header


def _write_header(f: BinaryIO, classname: str, version: int) -> None:
    b = classname.encode("ascii")
    f.write(bytes([len(b) | _NAME_LEN_MASK]))
    f.write(b)
    _write_fmt(f, "b", version)


def _expect_end(f: BinaryIO, classname: str) -> None:
    (flag,) = _read_fmt(f, "B")
    if flag != END_FLAG:
        raise ValueError(
            f"{classname}: end flag 0x{flag:02x} != 0x88 — field-layout mismatch"
        )


# ---------------------------------------------------------------------------
# nested serializable payloads
# ---------------------------------------------------------------------------


def _guard_version(name: str, version: int, implemented) -> None:
    """MRPT payloads carry no length prefix, so a version whose layout we
    do not know CANNOT be skipped or guessed at — fail loudly with the
    version so the mismatch is diagnosable (version-tolerance guard)."""
    if version not in implemented:
        raise ValueError(
            f"{name} stream version {version}: only version(s) "
            f"{sorted(implemented)} layouts are implemented — a different "
            f"version's field layout would be silently misparsed"
        )


def _quat_to_rot(qr: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Unit quaternion (r, x, y, z) -> 3x3 rotation matrix."""
    n = qr * qr + qx * qx + qy * qy + qz * qz
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * qr * qx, s * qr * qy, s * qr * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def _rot_to_quat(R: np.ndarray):
    """3x3 rotation matrix -> unit quaternion (r, x, y, z), r >= 0."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qr = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        qr, qx, qy, qz = q
    if qr < 0:
        qr, qx, qy, qz = -qr, -qx, -qy, -qz
    return qr, qx, qy, qz


def _read_pose3d(f: BinaryIO) -> np.ndarray:
    """CPose3D object. MRPT stream v1 nests the 4x4 homogeneous matrix as a
    CMatrixD object; v2 (what reference-era MRPT 1.x writes) streams the
    CPose3DQuat components x y z qr qx qy qz as 7 f64."""
    name, version = _read_header_required(f, "CPose3D")
    if name != "CPose3D":
        raise ValueError(f"expected CPose3D, got {name}")
    _guard_version(name, version, {1, 2})
    pose = np.eye(4)
    if version == 1:
        hm = _read_cmatrix(f)
        if hm.shape != (4, 4):
            raise ValueError(f"CPose3D v1: expected 4x4 HM, got {hm.shape}")
        pose[:, :] = hm
        pose[3, :] = (0, 0, 0, 1)
    else:
        x, y, z, qr, qx, qy, qz = _read_fmt(f, "7d")
        pose[:3, :3] = _quat_to_rot(qr, qx, qy, qz)
        pose[:3, 3] = (x, y, z)
    _expect_end(f, name)
    return pose


def _write_pose3d(f: BinaryIO, pose: np.ndarray) -> None:
    pose = np.asarray(pose, np.float64)
    _write_header(f, "CPose3D", 2)
    qr, qx, qy, qz = _rot_to_quat(pose[:3, :3])
    _write_fmt(f, "7d", pose[0, 3], pose[1, 3], pose[2, 3], qr, qx, qy, qz)
    _write_fmt(f, "B", END_FLAG)


def _read_cmatrix(f: BinaryIO) -> np.ndarray:
    """CMatrix/CMatrixF (f32) or CMatrixD (f64) object: rows, cols, data."""
    name, version = _read_header_required(f, "CMatrix")
    if name not in ("CMatrix", "CMatrixF", "CMatrixD"):
        raise ValueError(f"expected CMatrix/CMatrixD, got {name}")
    _guard_version(name, version, {0})
    rows, cols = _read_fmt(f, "II")
    if rows * cols > 1 << 26:
        raise ValueError(f"implausible matrix {rows}x{cols}")
    dt = np.dtype("<f8") if name == "CMatrixD" else np.dtype("<f4")
    data = np.frombuffer(_read(f, dt.itemsize * rows * cols), dt)
    _expect_end(f, name)
    return data.reshape(rows, cols).copy()


def _write_cmatrix(f: BinaryIO, m: np.ndarray, double: bool = False) -> None:
    _write_header(f, "CMatrixD" if double else "CMatrix", 0)
    m = np.asarray(m, np.float64 if double else np.float32)
    _write_fmt(f, "II", m.shape[0], m.shape[1])
    f.write(m.astype("<f8" if double else "<f4").tobytes())
    _write_fmt(f, "B", END_FLAG)


@dataclass
class TCamera:
    """mrpt::utils::TCamera — pinhole intrinsics + plumb-bob distortion,
    serialized as a nested object inside CObservation3DRangeScan v2+."""

    intrinsics: np.ndarray = field(default_factory=lambda: np.eye(3))  # 3x3 f64
    dist: np.ndarray = field(default_factory=lambda: np.zeros(5))  # k1 k2 p1 p2 k3
    focal_length_meters: float = 0.0
    nrows: int = 480
    ncols: int = 640


def _read_tcamera(f: BinaryIO) -> TCamera:
    """TCamera stream v0-2: focalLengthMeters (f64), dist[5] (f64), the 3x3
    intrinsicParams nested as a CMatrixD object; v0 then carried a dummy
    1x5 CMatrixD (skipped); v2 appends nrows/ncols (u32 each)."""
    name, version = _read_header_required(f, "TCamera")
    if name != "TCamera":
        raise ValueError(f"expected TCamera, got {name}")
    _guard_version(name, version, {0, 1, 2})
    cam = TCamera()
    (cam.focal_length_meters,) = _read_fmt(f, "d")
    cam.dist = np.asarray(_read_fmt(f, "5d"))
    cam.intrinsics = _read_cmatrix(f)
    if cam.intrinsics.shape != (3, 3):
        raise ValueError(f"TCamera intrinsics {cam.intrinsics.shape} != 3x3")
    if version == 0:
        _read_cmatrix(f)  # legacy distortionParams matrix, superseded by dist[]
    if version >= 2:
        cam.nrows, cam.ncols = _read_fmt(f, "II")
    _expect_end(f, name)
    return cam


def _write_tcamera(f: BinaryIO, cam: TCamera) -> None:
    _write_header(f, "TCamera", 2)
    _write_fmt(f, "d", cam.focal_length_meters)
    _write_fmt(f, "5d", *np.asarray(cam.dist, np.float64))
    _write_cmatrix(f, cam.intrinsics, double=True)
    _write_fmt(f, "II", cam.nrows, cam.ncols)
    _write_fmt(f, "B", END_FLAG)


def _read_cimage(f: BinaryIO) -> np.ndarray:
    """CImage stream v7-9 (reference-era MRPT 1.x writes v9):
    externalStorage flag (u8); if external, just the file name (refused —
    the pixels are not in the stream). In-stream: hasColor (u8), then

    * grayscale: width/height/origin/imageSize (i32 x4), storedAsZip (u8),
      then either a zlib block (u32 length + bytes) or imageSize raw bytes
      (imageSize = height*stride with the IplImage 4-byte row alignment);
    * color v8+: one i32 — negative means un-compressed (that value is
      -width, then -height follows, then height rows of width*3 raw BGR),
      positive means a JPEG/PNG blob of that many bytes (cv2.imdecode);
      color v7 and earlier: u32 blob length + JPEG bytes always.
    """
    name, version = _read_header_required(f, "CImage")
    if name != "CImage":
        raise ValueError(f"expected CImage, got {name}")
    _guard_version(name, version, {7, 8, 9})
    (external,) = _read_fmt(f, "B")
    if external:
        path = _read_string(f)
        _expect_end(f, name)
        raise ValueError(
            f"externally-stored CImage ({path!r}): pixels are not in the "
            "stream and the external image directory is not available"
        )
    (has_color,) = _read_fmt(f, "B")
    if not has_color:
        width, height, origin, image_size = _read_fmt(f, "iiii")
        if not (0 < width <= 1 << 14 and 0 < height <= 1 << 14):
            raise ValueError(f"implausible CImage {width}x{height}")
        (as_zip,) = _read_fmt(f, "B")
        if as_zip:
            (zlen,) = _read_fmt(f, "I")
            import zlib

            raw = zlib.decompress(_read(f, zlen))
            if len(raw) != image_size:
                raise ValueError("CImage zip block size mismatch")
        else:
            raw = _read(f, image_size)
        stride = image_size // height
        img = np.frombuffer(raw, np.uint8).reshape(height, stride)[:, :width].copy()
    else:
        (first,) = _read_fmt(f, "i")
        if version >= 8 and first < 0:
            width = -first
            (neg_h,) = _read_fmt(f, "i")
            height = -neg_h
            if not (0 < width <= 1 << 14 and 0 < height <= 1 << 14):
                raise ValueError(f"implausible CImage {width}x{height}")
            data = np.frombuffer(_read(f, width * height * 3), np.uint8)
            img = data.reshape(height, width, 3).copy()
        else:
            n_bytes = first
            if not 0 < n_bytes <= 1 << 28:
                raise ValueError(f"implausible CImage blob of {n_bytes} bytes")
            blob = np.frombuffer(_read(f, n_bytes), np.uint8)
            import cv2

            img = cv2.imdecode(blob, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError("CImage: cv2 could not decode compressed blob")
    _expect_end(f, name)
    return img


def _write_cimage(f: BinaryIO, img: np.ndarray, jpeg: bool = False) -> None:
    """Write a CImage v9. Grayscale goes raw (ZIP retired upstream in 2011);
    color goes raw via the negative-size v8+ form by default (byte-exact
    round-trips), or as a JPEG blob with jpeg=True (MRPT's default)."""
    _write_header(f, "CImage", 9)
    img = np.asarray(img, np.uint8)
    _write_fmt(f, "B", 0)  # in-stream
    if img.ndim == 2:
        _write_fmt(f, "B", 0)  # grayscale
        h, w = img.shape
        stride = (w + 3) & ~3  # IplImage 4-byte row alignment
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w] = img
        _write_fmt(f, "iiii", w, h, 0, h * stride)
        _write_fmt(f, "B", 0)  # not zip-compressed
        f.write(rows.tobytes())
    else:
        _write_fmt(f, "B", 1)  # color
        if jpeg:
            import cv2

            ok, blob = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
            if not ok:
                raise ValueError("cv2 JPEG encode failed")
            _write_fmt(f, "i", int(blob.size))
            f.write(blob.tobytes())
        else:
            _write_fmt(f, "ii", -img.shape[1], -img.shape[0])
            f.write(img.tobytes())
    _write_fmt(f, "B", END_FLAG)


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------


@dataclass
class Obs3DRangeScan:
    """CObservation3DRangeScan — one RGB-D capture inside a rawlog.
    LoadRawlog.cpp:247-283 consumes rangeImage/intensityImage/sensorPose/
    sensorLabel/timestamp; the remaining v6 fields are carried so a genuine
    MRPT archive round-trips losslessly."""

    sensor_label: str = ""
    timestamp: int = 0  # MRPT TTimeStamp (uint64 100-ns ticks)
    sensor_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    range_image: Optional[np.ndarray] = None  # (H,W) f32 metres
    intensity_image: Optional[np.ndarray] = None  # (H,W,3) u8 BGR
    max_range: float = 5.0
    std_error: float = 0.01
    points3d: Optional[np.ndarray] = None  # (N,3) f32, rarely stored
    confidence_image: Optional[np.ndarray] = None  # (H,W) u8
    camera_params: Optional[TCamera] = None  # depth camera (v2+)
    camera_params_intensity: Optional[TCamera] = None  # RGB camera (v4+)
    rel_pose_intensity_wrt_depth: np.ndarray = field(
        default_factory=lambda: np.eye(4)
    )  # (v4+)
    range_is_depth: bool = True  # v5+: Z-depth vs euclidean range
    intensity_image_channel: int = 0  # v6: 0=visible, 1=IR


@dataclass
class Obs2DRangeScan:
    """CObservation2DRangeScan — planar LIDAR scan. LoadRawlog.cpp:219-222
    only captures the pointer, but MRPT payloads carry no length prefix, so
    every field must still be traversed exactly to reach the next record."""

    sensor_label: str = "LASER"
    timestamp: int = 0
    ranges: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    valid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    aperture: float = float(np.pi)
    right_to_left: bool = True
    max_range: float = 80.0
    sensor_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    std_error: float = 0.01
    beam_aperture: float = 0.0
    delta_pitch: float = 0.0
    intensities: Optional[np.ndarray] = None  # (N,) i32 (v7)


def _read_obs3d(f: BinaryIO, version: int) -> Obs3DRangeScan:
    obs = Obs3DRangeScan()
    (obs.max_range,) = _read_fmt(f, "f")
    obs.sensor_pose = _read_pose3d(f)
    (has_points,) = _read_fmt(f, "B")
    if has_points:
        (n,) = _read_fmt(f, "I")
        if n > 1 << 26:
            raise ValueError(f"implausible points3D count {n}")
        xyz = [np.frombuffer(_read(f, 4 * n), np.dtype("<f4")) for _ in range(3)]
        obs.points3d = np.stack(xyz, axis=1).copy() if n else np.zeros((0, 3), "f4")
    (has_range,) = _read_fmt(f, "B")
    if has_range:
        obs.range_image = _read_cmatrix(f)
    (has_intensity,) = _read_fmt(f, "B")
    if has_intensity:
        obs.intensity_image = _read_cimage(f)
    if version >= 2:
        (has_confidence,) = _read_fmt(f, "B")
        if has_confidence:
            obs.confidence_image = _read_cimage(f)
        obs.camera_params = _read_tcamera(f)
    if version >= 4:
        obs.camera_params_intensity = _read_tcamera(f)
        obs.rel_pose_intensity_wrt_depth = _read_pose3d(f)
    (obs.std_error,) = _read_fmt(f, "f")
    (obs.timestamp,) = _read_fmt(f, "Q")
    obs.sensor_label = _read_string(f)
    if version >= 3:
        # externally-stored payload markers (flag + relative file name) for
        # points3D and rangeImage; when a flag is set the pixels live in a
        # side file that is not part of the stream — refuse rather than hand
        # the caller an observation with silently-missing depth
        (pts_ext,) = _read_fmt(f, "B")
        pts_file = _read_string(f)
        (rng_ext,) = _read_fmt(f, "B")
        rng_file = _read_string(f)
        if pts_ext or rng_ext:
            raise ValueError(
                f"externally-stored 3D-scan payloads ({pts_file!r}, "
                f"{rng_file!r}) are not available in this stream"
            )
    if version >= 5:
        (ridf,) = _read_fmt(f, "B")
        obs.range_is_depth = bool(ridf)
    if version >= 6:
        (obs.intensity_image_channel,) = _read_fmt(f, "b")
    return obs


def _default_tcamera(obs: Obs3DRangeScan) -> TCamera:
    """Kinect-like default intrinsics scaled to the stored resolution, used
    when writing a v6 record whose TCamera blocks were never populated (the
    v6 layout streams them unconditionally)."""
    if obs.range_image is not None:
        h, w = obs.range_image.shape
    else:
        h, w = 480, 640
    fx = 525.0 * w / 640.0
    k = np.array([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1.0]])
    return TCamera(intrinsics=k, nrows=h, ncols=w)


def _write_obs3d(f: BinaryIO, obs: Obs3DRangeScan) -> None:
    _write_fmt(f, "f", obs.max_range)
    _write_pose3d(f, obs.sensor_pose)
    _write_fmt(f, "B", obs.points3d is not None)
    if obs.points3d is not None:
        pts = np.asarray(obs.points3d, "<f4")
        _write_fmt(f, "I", pts.shape[0])
        for c in range(3):
            f.write(pts[:, c].tobytes())
    _write_fmt(f, "B", obs.range_image is not None)
    if obs.range_image is not None:
        _write_cmatrix(f, obs.range_image)
    _write_fmt(f, "B", obs.intensity_image is not None)
    if obs.intensity_image is not None:
        _write_cimage(f, obs.intensity_image)
    _write_fmt(f, "B", obs.confidence_image is not None)
    if obs.confidence_image is not None:
        _write_cimage(f, obs.confidence_image)
    _write_tcamera(f, obs.camera_params or _default_tcamera(obs))
    _write_tcamera(
        f, obs.camera_params_intensity or obs.camera_params or _default_tcamera(obs)
    )
    _write_pose3d(f, obs.rel_pose_intensity_wrt_depth)
    _write_fmt(f, "f", obs.std_error)
    _write_fmt(f, "Q", obs.timestamp)
    _write_string(f, obs.sensor_label)
    _write_fmt(f, "B", 0)
    _write_string(f, "")
    _write_fmt(f, "B", 0)
    _write_string(f, "")
    _write_fmt(f, "B", int(obs.range_is_depth))
    _write_fmt(f, "b", obs.intensity_image_channel)


def _read_obs2d(f: BinaryIO, version: int) -> Obs2DRangeScan:
    obs = Obs2DRangeScan()
    obs.aperture, rtl, obs.max_range = _read_fmt(f, "fBf")
    obs.right_to_left = bool(rtl)
    obs.sensor_pose = _read_pose3d(f)
    (n,) = _read_fmt(f, "I")
    if n > 1 << 20:
        raise ValueError(f"implausible scan length {n}")
    obs.ranges = np.frombuffer(_read(f, 4 * n), np.dtype("<f4")).copy()
    obs.valid = np.frombuffer(_read(f, n), np.uint8).copy()
    (obs.std_error,) = _read_fmt(f, "f")
    (obs.timestamp,) = _read_fmt(f, "Q")
    (obs.beam_aperture,) = _read_fmt(f, "d")
    obs.sensor_label = _read_string(f)
    if version >= 6:
        (obs.delta_pitch,) = _read_fmt(f, "d")
    if version >= 7:
        (has_int,) = _read_fmt(f, "B")
        if has_int:
            (ni,) = _read_fmt(f, "I")
            if ni > 1 << 20:
                raise ValueError(f"implausible intensity length {ni}")
            obs.intensities = np.frombuffer(
                _read(f, 4 * ni), np.dtype("<i4")
            ).copy()
    return obs


def _write_obs2d(f: BinaryIO, obs: Obs2DRangeScan) -> None:
    n = len(obs.ranges)
    valid = obs.valid if len(obs.valid) == n else np.ones(n, np.uint8)
    _write_fmt(f, "fBf", obs.aperture, int(obs.right_to_left), obs.max_range)
    _write_pose3d(f, obs.sensor_pose)
    _write_fmt(f, "I", n)
    f.write(np.asarray(obs.ranges, "<f4").tobytes())
    f.write(np.asarray(valid, np.uint8).tobytes())
    _write_fmt(f, "f", obs.std_error)
    _write_fmt(f, "Q", obs.timestamp)
    _write_fmt(f, "d", obs.beam_aperture)
    _write_string(f, obs.sensor_label)
    _write_fmt(f, "d", obs.delta_pitch)
    _write_fmt(f, "B", obs.intensities is not None)
    if obs.intensities is not None:
        _write_fmt(f, "I", len(obs.intensities))
        f.write(np.asarray(obs.intensities, "<i4").tobytes())


_READERS = {
    "CObservation3DRangeScan": (_read_obs3d, {2, 3, 4, 5, 6}),
    "CObservation2DRangeScan": (_read_obs2d, {6, 7}),
}


# ---------------------------------------------------------------------------
# rawlog container
# ---------------------------------------------------------------------------


def read_rawlog(path: str) -> Iterator[object]:
    """Yield observations from a rawlog (format #2: a gzip stream of
    observation objects — LoadRawlog.cpp:182-228 expects exactly this and
    throws on action/sensory-frame pairs)."""
    import zlib

    with gzip.open(path, "rb") as f:
        while True:
            # Clean end-of-stream is ONLY an empty read at an object
            # boundary (_read_header returns None). A mid-header or
            # mid-object EOF, or gzip-container damage, is a truncated
            # file and must raise — silently yielding a shortened
            # sequence would hide data loss from the caller.
            try:
                header = _read_header(f)
                if header is None:
                    return
                name, version = header
                reader, versions = _READERS.get(name, (None, None))
                if reader is None:
                    # no length prefix: an unknown class cannot be skipped
                    raise ValueError(f"unsupported rawlog object class {name!r}")
                _guard_version(name, version, versions)
                obs = reader(f, version)
                _expect_end(f, name)
            except (EOFError, gzip.BadGzipFile, zlib.error) as e:
                raise ValueError(f"truncated/corrupt rawlog stream: {e}") from e
            yield obs


def write_rawlog(path: str, observations: List[object]) -> None:
    """Write observations as a rawlog-format-#2 gzip stream."""
    with gzip.open(path, "wb") as f:
        for obs in observations:
            if isinstance(obs, Obs3DRangeScan):
                _write_header(f, "CObservation3DRangeScan", 6)
                _write_obs3d(f, obs)
            elif isinstance(obs, Obs2DRangeScan):
                _write_header(f, "CObservation2DRangeScan", 7)
                _write_obs2d(f, obs)
            else:
                raise TypeError(f"cannot serialize {type(obs).__name__}")
            _write_fmt(f, "B", END_FLAG)
