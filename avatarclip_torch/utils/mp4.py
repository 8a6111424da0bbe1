"""Motion-JPEG in an ISO base media file (MP4) with numpy and struct: the
port's replacement for OpenCV's video writer on ``motion.mp4``.

One video track of JPEG frames (utils/jpeg.py): sample entry ``mp4v`` whose
decoder configuration names object type 0x6C (ISO/IEC 10918-1, JPEG), one
chunk holding every frame, a constant frame duration. :func:`read_mp4_frames`
reads the frames of such a file back.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import encode_jpeg


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)  # 4-byte length form: 0x80 0x80 0x80 n
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F]) + body


_UNITY = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def mux_mjpeg(frames: list[bytes], width: int, height: int, fps: int) -> bytes:
    """JPEG frames -> the bytes of an MP4 file."""
    n = len(frames)
    sizes = [len(f) for f in frames]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    mdat_head = struct.pack(">I", 8 + sum(sizes)) + b"mdat"
    data_offset = len(ftyp) + len(mdat_head)
    ms = n * 1000 // fps
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, ms), struct.pack(">IH", 0x10000, 0x100),
                 b"\x00" * 10, _UNITY, b"\x00" * 24, struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, ms), b"\x00" * 8,
                 struct.pack(">HHHH", 0, 0, 0, 0), _UNITY, struct.pack(">II", width << 16, height << 16))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", b"\x00" * 12, b"VideoHandler\x00")
    vmhd = _full(b"vmhd", 0, 1, b"\x00" * 8)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
    dec_config = _descr(0x04, bytes([0x6C, 0x11]) + struct.pack(">I", max(sizes))[1:]
                        + struct.pack(">II", 0, 0))
    esds = _full(b"esds", 0, 0, _descr(0x03, struct.pack(">HB", 1, 0) + dec_config
                                       + _descr(0x06, b"\x02")))
    name = b"JPEG".ljust(32, b"\x00")
    mp4v = _box(b"mp4v", b"\x00" * 6, struct.pack(">H", 1), b"\x00" * 16,
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), name,
                struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(
        b"stbl",
        _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v),
        _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
        _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full(b"stsz", 0, 0, struct.pack(">II", 0, n), struct.pack(f">{n}I", *sizes)),
        _full(b"stco", 0, 0, struct.pack(">II", 1, data_offset)),
    )
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr,
                                                          _box(b"minf", vmhd, dinf, stbl))))
    return ftyp + mdat_head + b"".join(frames) + moov


def write_mp4(path: str, frames, fps: int = 30, quality: int = 90) -> None:
    """(H, W, 3) uint8 RGB frames -> a Motion-JPEG MP4 file."""
    jpegs, shape = [], None
    for img in frames:
        img = np.asarray(img)
        if shape is not None and img.shape != shape:
            raise ValueError("all frames must have one shape")
        shape = img.shape
        jpegs.append(encode_jpeg(img, quality))
    if not jpegs:
        raise ValueError("write_mp4 needs at least one frame")
    with open(path, "wb") as f:
        f.write(mux_mjpeg(jpegs, shape[1], shape[0], fps))


def _children(data: bytes, start: int, end: int):
    pos = start
    while pos < end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, pos + 8, pos + size
        pos += size


def read_mp4_frames(path: str) -> list[bytes]:
    """The samples of the first track of an MP4 file (its JPEG frames)."""
    with open(path, "rb") as f:
        data = f.read()
    boxes = {}

    def walk(start, end):
        for kind, b0, b1 in _children(data, start, end):
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                walk(b0, b1)
            elif kind in (b"stsz", b"stco", b"stsc") and kind not in boxes:
                boxes[kind] = data[b0 + 4:b1]  # past version and flags

    walk(0, len(data))
    size0, n = struct.unpack(">II", boxes[b"stsz"][:8])
    sizes = [size0] * n if size0 else list(struct.unpack(f">{n}I", boxes[b"stsz"][8:8 + 4 * n]))
    (n_chunks,) = struct.unpack(">I", boxes[b"stco"][:4])
    offsets = struct.unpack(f">{n_chunks}I", boxes[b"stco"][4:4 + 4 * n_chunks])
    (n_runs,) = struct.unpack(">I", boxes[b"stsc"][:4])
    runs = [struct.unpack(">III", boxes[b"stsc"][4 + 12 * i:16 + 12 * i]) for i in range(n_runs)]
    frames, k = [], 0
    for c in range(n_chunks):
        per = [r[1] for r in runs if r[0] <= c + 1][-1]
        pos = offsets[c]
        for _ in range(per):
            if k == n:
                break
            frames.append(data[pos:pos + sizes[k]])
            pos += sizes[k]
            k += 1
    return frames
