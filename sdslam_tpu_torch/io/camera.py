"""Live V4L2 camera capture for the monocular front-end (port of
sdslam_tpu/io/camera.py; host only).

The reference's monocular example opens `/dev/videoN` with OpenCV
VideoCapture and paces the loop at the camera rate (Examples/Monocular/
monocular.cc). The capture path here talks V4L2 directly: ioctl (QUERYCAP /
S_FMT / REQBUFS / QBUF / STREAMON / DQBUF) and mmap'd buffers, the
mechanics of OpenCV's V4L2 backend, with the YUYV->gray conversion in numpy
(SLAM consumes intensity only; Y is the first byte of every YUYV pair).

Pixel formats, tried in order: GREY (native intensity), YUYV (Y plane
extracted), MJPG (decoded by PIL, imported where it is used). Every
structure layout and ioctl number is the x86_64 ABI.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import select
import struct
import time
from typing import Optional, Tuple

import numpy as np

# ---- ioctl plumbing (x86_64) ---------------------------------------------

_IOC_WRITE, _IOC_READ = 1, 2


def _ioc(dir_, nr, size):
    return (dir_ << 30) | (size << 16) | (ord("V") << 8) | nr


_CAP_SIZE = 104  # v4l2_capability
_FMT_SIZE = 208  # v4l2_format
_REQ_SIZE = 20  # v4l2_requestbuffers
_BUF_SIZE = 88  # v4l2_buffer (64-bit)

VIDIOC_QUERYCAP = _ioc(_IOC_READ, 0, _CAP_SIZE)
VIDIOC_S_FMT = _ioc(_IOC_READ | _IOC_WRITE, 5, _FMT_SIZE)
VIDIOC_REQBUFS = _ioc(_IOC_READ | _IOC_WRITE, 8, _REQ_SIZE)
VIDIOC_QUERYBUF = _ioc(_IOC_READ | _IOC_WRITE, 9, _BUF_SIZE)
VIDIOC_QBUF = _ioc(_IOC_READ | _IOC_WRITE, 15, _BUF_SIZE)
VIDIOC_DQBUF = _ioc(_IOC_READ | _IOC_WRITE, 17, _BUF_SIZE)
VIDIOC_STREAMON = _ioc(_IOC_WRITE, 18, 4)
VIDIOC_STREAMOFF = _ioc(_IOC_WRITE, 19, 4)

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_NONE = 1


def _fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


PIX_GREY = _fourcc("GREY")
PIX_YUYV = _fourcc("YUYV")
PIX_MJPG = _fourcc("MJPG")


def yuyv_to_gray(buf: bytes, width: int, height: int) -> np.ndarray:
    """Extract the Y plane of a packed YUYV frame (every other byte)."""
    arr = np.frombuffer(buf, np.uint8, count=width * height * 2)
    return arr[0::2].reshape(height, width).copy()


def mjpg_to_gray(buf: bytes) -> np.ndarray:
    import io as _io

    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(bytes(buf))).convert("L"))


class V4L2Camera:
    """Minimal mmap streaming capture. `read()` returns (timestamp, gray)."""

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, n_buffers: int = 4):
        self.device = device
        self.width, self.height = width, height
        self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self._maps = []
        self._fmt = None
        try:
            self._setup(n_buffers)
        except Exception:
            self.close()
            raise

    def _ioctl(self, req, buf):
        return fcntl.ioctl(self.fd, req, buf)

    def _setup(self, n_buffers: int):
        cap = bytearray(_CAP_SIZE)
        self._ioctl(VIDIOC_QUERYCAP, cap)
        # negotiate a pixel format
        last_err: Optional[Exception] = None
        for pix in (PIX_GREY, PIX_YUYV, PIX_MJPG):
            fmt = bytearray(_FMT_SIZE)
            struct.pack_into("<L", fmt, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            # union starts at offset 8 (64-bit alignment)
            struct.pack_into(
                "<LLLL", fmt, 8, self.width, self.height, pix, V4L2_FIELD_NONE
            )
            try:
                self._ioctl(VIDIOC_S_FMT, fmt)
            except OSError as e:  # format rejected
                last_err = e
                continue
            got_w, got_h, got_pix = struct.unpack_from("<LLL", fmt, 8)
            if got_pix == pix:
                self.width, self.height = got_w, got_h
                self._fmt = pix
                break
        if self._fmt is None:
            raise RuntimeError(
                f"{self.device}: no supported pixel format (GREY/YUYV/MJPG)"
            ) from last_err
        # request + map buffers
        req = bytearray(_REQ_SIZE)
        struct.pack_into(
            "<LLL", req, 0, n_buffers, V4L2_BUF_TYPE_VIDEO_CAPTURE,
            V4L2_MEMORY_MMAP,
        )
        self._ioctl(VIDIOC_REQBUFS, req)
        count = struct.unpack_from("<L", req, 0)[0]
        for i in range(count):
            # v4l2_buffer (x86_64): index@0 type@4 bytesused@8 ...
            # memory@60, m.offset@64, length@72
            b = bytearray(_BUF_SIZE)
            struct.pack_into("<LL", b, 0, i, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("<L", b, 60, V4L2_MEMORY_MMAP)
            self._ioctl(VIDIOC_QUERYBUF, b)
            length = struct.unpack_from("<L", b, 72)[0]
            offset = struct.unpack_from("<L", b, 64)[0]
            self._maps.append(
                mmap.mmap(self.fd, length, mmap.MAP_SHARED,
                          mmap.PROT_READ, offset=offset)
            )
            self._ioctl(VIDIOC_QBUF, b)
        self._ioctl(VIDIOC_STREAMON,
                    struct.pack("<L", V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def read(self, timeout: float = 2.0) -> Tuple[float, np.ndarray]:
        """Dequeue one frame; returns (monotonic timestamp, gray u8 [H,W])."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            raise TimeoutError(f"{self.device}: no frame within {timeout}s")
        b = bytearray(_BUF_SIZE)
        struct.pack_into("<L", b, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<L", b, 60, V4L2_MEMORY_MMAP)
        self._ioctl(VIDIOC_DQBUF, b)
        idx = struct.unpack_from("<L", b, 0)[0]
        used = struct.unpack_from("<L", b, 8)[0]
        ts = time.monotonic()
        raw = self._maps[idx][: used or None]
        if self._fmt == PIX_GREY:
            img = np.frombuffer(raw, np.uint8,
                                count=self.width * self.height).reshape(
                self.height, self.width).copy()
        elif self._fmt == PIX_YUYV:
            img = yuyv_to_gray(raw, self.width, self.height)
        else:
            img = mjpg_to_gray(raw)
        # requeue
        self._ioctl(VIDIOC_QBUF, b)
        return ts, img

    def close(self):
        if self.fd >= 0:
            try:
                self._ioctl(VIDIOC_STREAMOFF,
                            struct.pack("<L", V4L2_BUF_TYPE_VIDEO_CAPTURE))
            except OSError:
                pass
            for m in self._maps:
                m.close()
            self._maps = []
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def live_frames(device: str, width: int, height: int, fps: float = 30.0):
    """Generator of (timestamp, gray) frames paced at the configured rate
    (the reference's usleep-paced loop). Frames arriving faster than the
    pace are still consumed: fresh data wins."""
    period = 1.0 / max(fps, 1e-3)
    with V4L2Camera(device, width, height) as cam:
        next_t = time.monotonic()
        while True:
            ts, img = cam.read()
            yield ts, img
            next_t += period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()
