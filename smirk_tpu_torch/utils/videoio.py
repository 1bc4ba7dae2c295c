"""Pure-Python MJPEG-AVI video IO (the cv2-free fallback of the video
demo). A copy of smirk_tpu/utils/videoio.py.

The reference's video demo requires OpenCV for both decode and encode.
Here cv2 is optional: when it is absent, demo_video falls back to
Motion-JPEG in an AVI (RIFF) container, demuxed/muxed by this module with
PIL (imported where a frame is coded) doing the JPEG codec work.
MJPEG-AVI is the one mainstream video format whose container is simple
enough to parse by hand and whose per-frame codec (baseline JPEG) ships
with PIL; full H.264/mp4 support without cv2 is out of scope.

The writer emits a standard AVI 1.0 file (hdrl with avih/strh/strf, movi
chunk stream, idx1 index) that OpenCV, ffmpeg, and VLC accept; the reader
walks the RIFF tree and accepts both these files and OpenCV's MJPG output.
"""
from __future__ import annotations

import io
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# RIFF plumbing
# --------------------------------------------------------------------------


def _read_chunks(buf: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for a RIFF chunk run."""
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _find_list(buf: bytes, start: int, end: int, name: bytes) -> Optional[Tuple[int, int]]:
    """Locate a LIST chunk of the given type; returns (payload_start, end)."""
    for fourcc, p, size in _read_chunks(buf, start, end):
        if fourcc == b"LIST" and buf[p:p + 4] == name:
            return p + 4, p + size
        if fourcc == b"LIST":
            found = _find_list(buf, p + 4, p + size, name)
            if found:
                return found
    return None


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------


def read_mjpeg_avi_meta(path: str) -> dict:
    """Container metadata: {'fps': float, 'size': (w, h), 'frames': int}."""
    with open(path, "rb") as f:
        head = f.read(4096)
    if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI (RIFF) file")
    hdrl = _find_list(head, 12, len(head), b"hdrl")
    if not hdrl:
        raise ValueError(f"{path}: no hdrl header list in the first 4KB")
    fps, size, frames = 25.0, (0, 0), 0
    for fourcc, p, sz in _read_chunks(head, hdrl[0], hdrl[1]):
        if fourcc == b"avih" and sz >= 40:
            us_per_frame, _, _, _, total, _, _, _, w, h = struct.unpack(
                "<10I", head[p:p + 40])
            if us_per_frame:
                fps = 1e6 / us_per_frame
            size, frames = (w, h), total
    return {"fps": fps, "size": size, "frames": frames}


def iter_mjpeg_avi(path: str) -> Iterator[np.ndarray]:
    """Yield RGB uint8 (H, W, 3) frames from an MJPEG AVI.

    Accepts compressed ('##dc') and uncompressed-flagged ('##db') video
    chunks of the first video stream; each payload must be a JPEG (PIL
    decodes it). Skips empty chunks (some muxers emit zero-length drop
    frames).
    """
    from PIL import Image

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI (RIFF) file")
    movi = _find_list(buf, 12, len(buf), b"movi")
    if not movi:
        raise ValueError(f"{path}: no movi list (empty or truncated AVI)")
    for fourcc, p, size in _read_chunks(buf, movi[0], movi[1]):
        if fourcc == b"LIST" and buf[p:p + 4] == b"rec ":
            inner = _read_chunks(buf, p + 4, p + size)
        else:
            inner = [(fourcc, p, size)]
        for cc, q, sz in inner:
            if sz and cc[2:4] in (b"dc", b"db") and cc[:2].isdigit():
                img = Image.open(io.BytesIO(buf[q:q + sz]))
                yield np.asarray(img.convert("RGB"))


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


class MjpegAviWriter:
    """Minimal AVI 1.0 muxer for a single MJPG video stream.

    Frames are RGB uint8 (H, W, 3); all frames must share one shape.
    Buffers JPEG payloads in memory and writes the container on close()
    (framework videos are short demo panels; a streaming two-pass writer
    is not worth the complexity here).
    """

    def __init__(self, path: str, fps: float = 25.0, quality: int = 90):
        self.path = path
        self.fps = float(fps)
        self.quality = int(quality)
        self._payloads: List[bytes] = []
        self._size: Optional[Tuple[int, int]] = None  # (w, h)

    def write(self, frame: np.ndarray) -> None:
        from PIL import Image

        frame = np.ascontiguousarray(frame)
        if frame.dtype != np.uint8:
            raise ValueError("MjpegAviWriter expects uint8 RGB frames")
        h, w = frame.shape[:2]
        if self._size is None:
            self._size = (w, h)
        elif self._size != (w, h):
            raise ValueError(
                f"frame size {(w, h)} != first frame {self._size}")
        bio = io.BytesIO()
        Image.fromarray(frame).save(bio, "JPEG", quality=self.quality)
        self._payloads.append(bio.getvalue())

    def close(self) -> None:
        if self._size is None:
            raise ValueError("no frames written")
        w, h = self._size
        n = len(self._payloads)
        max_len = max(len(p) for p in self._payloads)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) & 1 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        avih = struct.pack(
            "<14I",
            int(round(1e6 / self.fps)),  # dwMicroSecPerFrame
            int(max_len * self.fps),     # dwMaxBytesPerSec (advisory)
            0,                           # dwPaddingGranularity
            0x10,                        # dwFlags = AVIF_HASINDEX
            n, 0, 1,                     # frames, initial frames, streams
            max_len, w, h, 0, 0, 0, 0,
        )
        # dwScale/dwRate encode the frame rate as a rational
        strh = (
            b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1000,
                          int(round(self.fps * 1000)), 0, n, max_len,
                          0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h)
        )
        strf = struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
            0, 0, 0, 0,
        )
        # chunk() writes fourcc+size+payload, so chunk(b"LIST", b"strl"+...)
        # comes out as 'LIST' <size> 'strl' <children> — the RIFF nesting rule
        strl = b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
        hdrl = b"hdrl" + chunk(b"avih", avih) + chunk(b"LIST", strl)

        movi_children = b""
        index = b""
        offset = 4  # idx1 offsets are relative to the 'movi' fourcc
        for payload in self._payloads:
            ck = chunk(b"00dc", payload)
            movi_children += ck
            index += b"00dc" + struct.pack(
                "<III", 0x10, offset, len(payload))  # AVIIF_KEYFRAME
            offset += len(ck)
        movi = b"movi" + movi_children

        body = chunk(b"LIST", hdrl) + chunk(b"LIST", movi) + chunk(
            b"idx1", index)
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI ")
            f.write(body)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


def write_mjpeg_avi(path: str, frames, fps: float = 25.0,
                    quality: int = 90) -> None:
    with MjpegAviWriter(path, fps=fps, quality=quality) as vw:
        for fr in frames:
            vw.write(np.asarray(fr))


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401

        # guard against stubbed modules: demo_video needs BOTH ends
        # (decode via VideoCapture, mux via VideoWriter)
        cv2.VideoCapture
        cv2.VideoWriter
        return True
    except Exception:  # pragma: no cover - import environment dependent
        return False
