"""Minimal PNG reader / writer in numpy + zlib (8-bit RGB / RGBA / grey,
non-interlaced): the port's replacement for imageio on the images the
pipelines read and write."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF
    )


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png takes uint8 images")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(H))
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB/RGBA PNGs are supported")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * C)
    out = np.zeros((H, W * C), np.int32)
    prev = np.zeros(W * C, np.int32)
    for y in range(H):
        ft, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft in (1, 3, 4):
            # left-dependent filters run per pixel
            cur = np.zeros_like(line)
            for x in range(0, W * C, C):
                a = cur[x - C:x] if x else np.zeros(C, np.int32)
                b = prev[x:x + C]
                c = prev[x - C:x] if x else np.zeros(C, np.int32)
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:
                    pred = _paeth(a, b, c)
                cur[x:x + C] = (line[x:x + C] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(H, W, C)
