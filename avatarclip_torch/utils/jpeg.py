"""Baseline JPEG encoder in numpy (8-bit RGB, 4:4:4, the Annex K tables): the
port's replacement for imageio on the candidate renders and the frames of
``utils/mp4.py``. The DCT, quantisation and run-length coding are vectorised
over all blocks; the entropy-coded bits are packed with numpy too, so a
512^2 frame takes a fraction of a second on the host."""

from __future__ import annotations

import struct

import numpy as np

# Annex K.1 quantisation tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int32)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int32)

# zig-zag scan: _ZIGZAG[k] is the natural index of the k-th coefficient
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                    (i % 8) if (i // 8 + i % 8) % 2 == 0 else (i // 8))),
                   np.int64)

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
    "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
    "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
    "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _huffman(spec) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a (counts, symbols) table -> (code, length) arrays
    indexed by symbol."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    c[0] *= 1 / np.sqrt(2)
    return c


_DCT = _dct_matrix()


def _scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * s + 50) // 100, 1, 255)


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(size category, appended bits) of signed coefficient values."""
    a = np.abs(v)
    size = np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _channel_codes(blocks: np.ndarray, dc_tab, ac_tab) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantised zig-zag blocks (N, 64) int -> (codes, lengths, block of
    each) of this channel's symbols and appended bits, in scan order within
    each block (the caller interleaves the channels' blocks). Within a block
    the symbols sort by a key: DC code 0, DC bits 0.5; for the nonzero AC
    coefficient at zig-zag index n, its ZRLs n - 0.9 + k / 1000, its code n
    and its bits n + 0.5; the EOB 100."""
    N = blocks.shape[0]
    dc = blocks[:, 0]
    diff = np.diff(dc, prepend=0)
    dsize, dbits = _magnitude(diff)
    ac = blocks[:, 1:]
    nz = ac != 0
    # per block: the nonzero AC positions, runs of zeros between them (runs of
    # 16 or more emit ZRL 0xF0 first) and an EOB unless the last AC is nonzero
    parts_code, parts_len, parts_block, parts_order = [], [], [], []
    # DC symbol + its bits
    dcode, dlen = dc_tab
    parts_code += [dcode[dsize], dbits]
    parts_len += [dlen[dsize], dsize]
    parts_block += [np.arange(N), np.arange(N)]
    parts_order += [np.zeros(N), np.full(N, 0.5)]
    bi, pos = np.nonzero(nz)
    if bi.size:
        first = np.r_[True, bi[1:] != bi[:-1]]
        prev = np.where(first, -1, np.r_[-1, pos[:-1]])
        run = pos - prev - 1
        n_zrl = run // 16
        run = run % 16
        val = ac[bi, pos]
        size, bits = _magnitude(val)
        acode, alen = ac_tab
        sym = run * 16 + size
        # ZRL symbols: repeat each (block, position) n_zrl times just before it
        zi = np.repeat(np.arange(bi.size), n_zrl)
        if zi.size:
            k = np.arange(zi.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
            parts_code.append(np.full(zi.size, acode[0xF0]))
            parts_len.append(np.full(zi.size, alen[0xF0]))
            parts_block.append(bi[zi])
            parts_order.append(pos[zi] + 0.1 + k * 1e-3)
        parts_code += [acode[sym], bits]
        parts_len += [alen[sym], size]
        parts_block += [bi, bi]
        parts_order += [1.0 + pos, 1.5 + pos]
    last = np.where(nz.any(1), 62 - np.argmax(nz[:, ::-1], 1), -1)
    eob = np.nonzero(last < 62)[0]
    acode, alen = ac_tab
    parts_code.append(np.full(eob.size, acode[0x00]))
    parts_len.append(np.full(eob.size, alen[0x00]))
    parts_block.append(eob)
    parts_order.append(np.full(eob.size, 100.0))
    code = np.concatenate(parts_code).astype(np.int64)
    length = np.concatenate(parts_len).astype(np.int64)
    order = np.lexsort((np.concatenate(parts_order), np.concatenate(parts_block)))
    blk = np.concatenate(parts_block)[order]
    return code[order], length[order], blk


def _pack_bits(code: np.ndarray, length: np.ndarray) -> bytes:
    """MSB-first bit packing of (code, length) pairs, padded with 1 bits, with
    0x00 stuffed after every 0xFF byte."""
    keep = length > 0
    code, length = code[keep], length[keep]
    total = int(length.sum())
    ends = np.cumsum(length)
    starts = ends - length
    # bit j of symbol i (j = 0 is its most significant) lands at starts[i] + j
    sym = np.repeat(np.arange(code.size), length)
    j = np.arange(total) - np.repeat(starts, length)
    bits = (code[sym] >> (length[sym] - 1 - j)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    if ff.size:
        data = np.insert(data, ff + 1, 0)
    return data.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(cls_id: int, spec) -> bytes:
    counts, symbols = spec
    return bytes([cls_id]) + bytes(counts) + bytes(symbols)


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JFIF bytes (4:4:4, one scan)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("encode_jpeg takes (H, W, 3) uint8 images")
    H, W, _ = img.shape
    x = img.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128.0,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128.0,
    ], 0) - 128.0
    Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
    ycc = np.pad(ycc, ((0, 0), (0, Hp - H), (0, Wp - W)), mode="edge")
    blocks = ycc.reshape(3, Hp // 8, 8, Wp // 8, 8).transpose(0, 1, 3, 2, 4).reshape(3, -1, 8, 8)
    coef = np.einsum("ij,cnjk,lk->cnil", _DCT, blocks, _DCT).reshape(3, -1, 64)
    qt = [_scaled_table(_Q_LUMA, quality), _scaled_table(_Q_CHROMA, quality)]
    tabs = [(_huffman(_DC_LUMA), _huffman(_AC_LUMA)), (_huffman(_DC_CHROMA), _huffman(_AC_CHROMA))]
    codes, lens, blks, comp = [], [], [], []
    for c in range(3):
        t = 0 if c == 0 else 1
        q = np.round(coef[c] / qt[t]).astype(np.int64)[:, _ZIGZAG]
        code, length, blk = _channel_codes(q, *tabs[t])
        codes.append(code)
        lens.append(length)
        blks.append(blk)
        comp.append(np.full(code.size, c))
    # interleave: every MCU is (Y, Cb, Cr) of one block position
    order = np.lexsort((np.arange(sum(c.size for c in codes)), np.concatenate(comp),
                        np.concatenate(blks)))
    scan = _pack_bits(np.concatenate(codes)[order], np.concatenate(lens)[order])
    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, b"\x00" + bytes(qt[0][_ZIGZAG].astype(np.uint8))
                    + b"\x01" + bytes(qt[1][_ZIGZAG].astype(np.uint8))),
           _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 3)
                    + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])),
           _segment(0xFFC4, _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
                    + _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)),
           _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))


def jpeg_markers(data: bytes) -> list[int]:
    """The marker sequence of a JPEG stream up to its scan and the end (SOI,
    segments, SOS, EOI); raises on a malformed stream."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise ValueError("not a JPEG stream (no SOI / EOI)")
    pos, markers = 2, [0xFFD8]
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        marker = 0xFF00 | data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        markers.append(marker)
        pos += 2 + n
        if marker == 0xFFDA:
            break
    return markers + [0xFFD9]
