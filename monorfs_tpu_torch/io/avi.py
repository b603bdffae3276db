"""Minimal MJPEG AVI writer / reader with a baseline JPEG encoder in NumPy
and a baseline JPEG decoder whose pixel work runs on the device: the torch
port's counterpart of monorfs_tpu.io.avi, which encodes and decodes through
PIL. This one needs only NumPy, PyTorch and the standard library.

The reference recording embeds a `sidebar.avi` with the sensor view
(Simulation.cs:391-488 writes it via Util.SaveAsAvi, Util.cs:297-378). The
container is AVI 1.0 RIFF with one MJPG video stream, one JPEG per frame and
the idx1 index. The encoder writes baseline JFIF (ITU T.81): 8x8 DCT, the
Annex K quantisation tables scaled by quality as the IJG library scales
them, the Annex K Huffman tables, no chroma subsampling; a [H, W] frame is
one grey component, a [H, W, 3] frame YCbCr.

The decoder (`jpeg_decode`, `decode_frames`) reads baseline sequential JPEG
(SOF0) with one or three components at the sampling factors 4:4:4, 4:2:2
and 4:2:0 (the JAX package's PIL encodings are 4:2:0, this module's 4:4:4),
with restart intervals, in one interleaved scan or one scan a component,
at any size. Progressive, lossless and arithmetic-coded JPEG raise. The
Huffman decoding is serial and runs on the host (`parse_jpeg`); then for the
whole frame at once on the device (`reconstruct`): the dequantisation,
the 8x8 IDCT of every block at once in libjpeg's own integer arithmetic
(its "islow" IDCT, jidctint.c, the method PIL decodes with), the
upsampling of subsampled chroma with libjpeg's "fancy" triangular filter
(PIL's default), and YCbCr to RGB with libjpeg's fixed-point tables and
rounding. All of it is integer arithmetic, so the pixels equal PIL's
(libjpeg's) and are the same on every device.
"""

import struct

import numpy as np
import torch

from .. import resolve_device

# ITU T.81 Annex K: luminance / chrominance quantisation (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32)
# natural index of each zig-zag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
# orthonormal 8-point DCT-II: F = C X C^T is T.81's FDCT
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _quant_table(base, quality):
    """Annex K table scaled as the IJG library scales it (1 <= q <= 100)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table):
    """{symbol: (code, length)} of a canonical Huffman table."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


class _BitWriter:
    """MSB-first entropy-coded bytes, 0xFF stuffed with 0x00."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1-bits
        return bytes(self.out)


def _blocks(plane):
    """[H, W] -> [rows * cols, 8, 8] blocks in raster order, edge-padded."""
    h, w = plane.shape
    ph, pw = -h % 8, -w % 8
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    r, c = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(r, 8, c, 8).transpose(0, 2, 1, 3).reshape(r * c, 8, 8)


def _segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _size_and_bits(v):
    """(category, amplitude bits) of a coefficient (T.81 F.1.2.1)."""
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def jpeg_encode(frame, quality=85):
    """Baseline JPEG of a uint8 [H, W] (grey) or [H, W, 3] (RGB) frame; any
    other dtype is first scaled to 0-255 over its own range. Returns
    (bytes, (w, h))."""
    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
    h, w = arr.shape[:2]
    x = arr.astype(np.float64)
    if arr.ndim == 2:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    tables = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    huff = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
    comp_table = [0] + [1] * (len(planes) - 1)

    coeffs = []  # per component: [blocks, 64] quantised, zig-zag order
    for plane, t in zip(planes, comp_table):
        blk = _blocks(plane) - 128.0
        dct = _DCT @ blk @ _DCT.T
        q = np.round(dct.reshape(-1, 64) / tables[t]).astype(np.int64)
        coeffs.append(q[:, ZIGZAG])

    codes = [(_huffman_codes(dc), _huffman_codes(ac)) for dc, ac in huff]
    bits = _BitWriter()
    prev_dc = [0] * len(planes)
    for bi in range(coeffs[0].shape[0]):
        for ci, t in enumerate(comp_table):
            dc_codes, ac_codes = codes[t]
            block = coeffs[ci][bi]
            size, amp = _size_and_bits(int(block[0]) - prev_dc[ci])
            prev_dc[ci] = int(block[0])
            bits.put(*dc_codes[size])
            if size:
                bits.put(amp, size)
            nonzero = np.flatnonzero(block[1:]) + 1
            last = 0
            for k in nonzero:
                run = k - last - 1
                while run > 15:
                    bits.put(*ac_codes[0xF0])  # ZRL: 16 zeros
                    run -= 16
                size, amp = _size_and_bits(int(block[k]))
                bits.put(*ac_codes[(run << 4) | size])
                bits.put(amp, size)
                last = k
            if last < 63:
                bits.put(*ac_codes[0x00])  # EOB
    scan = bits.flush()

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid in sorted(set(comp_table)):
        out += _segment(0xDB, bytes([tid]) + bytes(tables[tid][ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for ci, t in enumerate(comp_table):
        sof += bytes([ci + 1, 0x11, t])
    out += _segment(0xC0, sof)
    for tid in sorted(set(comp_table)):
        for cls, (counts, symbols) in enumerate(huff[tid]):
            out += _segment(0xC4, bytes([(cls << 4) | tid]) + bytes(counts) + bytes(symbols))
    sos = bytes([len(planes)])
    for ci, t in enumerate(comp_table):
        sos += bytes([ci + 1, (t << 4) | t])
    out += _segment(0xDA, sos + b"\x00\x3f\x00")
    out += scan + b"\xff\xd9"
    return bytes(out), (w, h)


def jpeg_size(data):
    """(w, h) from a JPEG's SOF segment."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("not a JPEG marker")
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in (0xC0, 0xC1, 0xC2):
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return w, h
        pos += 2 + length
    raise ValueError("no SOF segment")


def write_mjpeg(path_or_file, frames, fps=30, quality=85):
    """Write frames (uint8 [H, W] / [H, W, 3] arrays, or encoded JPEG bytes)
    as an MJPEG AVI. Returns the number of frames written."""
    encoded = []
    size = None
    for f in frames:
        if isinstance(f, (bytes, bytearray)):
            data = bytes(f)
            if size is None:
                size = jpeg_size(data)
        else:
            data, size = jpeg_encode(f, quality)
        if len(data) % 2:
            data += b"\x00"
        encoded.append(data)
    if not encoded:
        raise ValueError("no frames")
    w, h = size
    n = len(encoded)
    max_size = max(len(d) for d in encoded)

    def chunk(fourcc, payload):
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc, payload):
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1e6 / fps),  # dwMicroSecPerFrame
        max_size * fps,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        0x10,  # AVIF_HASINDEX
        n, 0, 1,  # frames, initial, streams
        max_size,  # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0,
    )
    strh = (
        b"vids" + b"MJPG"
        + struct.pack("<I2HI", 0, 0, 0, 0)  # flags, prio, lang, initial
        + struct.pack("<2I", 1, fps)  # scale, rate
        + struct.pack("<3I", 0, n, max_size)  # start, length, bufsize
        + struct.pack("<iI", -1, 0)  # quality, samplesize
        + struct.pack("<4h", 0, 0, w, h)  # rcFrame
    )
    strf = struct.pack("<I2i2H4s5I", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"movi"
    idx = b""
    for d in encoded:
        offset = len(movi_payload)
        movi_payload += chunk(b"00dc", d)
        idx += b"00dc" + struct.pack("<3I", 0x10, offset, len(d))
    riff_payload = b"AVI " + hdrl + chunk(b"LIST", movi_payload) + chunk(b"idx1", idx)
    data = b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)
    return n


def read_mjpeg(path_or_file):
    """The JPEG payloads of an MJPEG AVI (this writer's layout or any
    standard single-video-stream file), as a list of byte strings."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    frames = []

    def walk(buf, pos, end):
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
            body = pos + 8
            if fourcc == b"LIST":
                walk(buf, body + 4, body + size)
            elif fourcc[2:4] in (b"dc", b"db"):
                frames.append(buf[body:body + size].rstrip(b"\x00"))
            pos = body + size + (size & 1)

    walk(data, 12, len(data))
    return frames


# ---- decoding -------------------------------------------------------------------

_FIX16 = lambda x: int(x * 65536 + 0.5)  # libjpeg's FIX() at SCALEBITS 16


def _decode_lut(counts, symbols):
    """(length, symbol) lists indexed by the next 16 bits of the stream."""
    length = [0] * 65536
    symbol = [0] * 65536
    code, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - n_bits)
            span = 1 << (16 - n_bits)
            length[lo:lo + span] = [n_bits] * span
            symbol[lo:lo + span] = [symbols[k]] * span
            code, k = code + 1, k + 1
        code <<= 1
    return length, symbol


def _entropy_segments(data, pos):
    """The scan's entropy-coded bytes from pos, split at its restart
    markers and unstuffed; returns (segments, position of the next marker)."""
    end = pos
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= len(data):
            raise ValueError("JPEG scan runs past the end of the data")
        nxt = data[end + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            end += 2 if nxt != 0xFF else 1
            continue
        break
    raw = data[pos:end]
    segments, start, i = [], 0, raw.find(b"\xff")
    while i >= 0:
        if i + 1 < len(raw) and 0xD0 <= raw[i + 1] <= 0xD7:
            segments.append(raw[start:i])
            start = i + 2
        i = raw.find(b"\xff", i + 2 if i + 1 < len(raw) and raw[i + 1] == 0 else i + 1)
    segments.append(raw[start:])
    return [seg.replace(b"\xff\x00", b"\xff") for seg in segments], end


def _decode_scan(segments, comps, blocks_of, restart, n_units, coef, luts):
    """Huffman-decode one scan into coef[c] (int32 [rows, cols, 64],
    natural order). comps: the scan's component ids; blocks_of(unit) the
    (component, block row, block col) of each block of a unit (an MCU, or
    one block of a single-component scan)."""
    zz = ZIGZAG.tolist()
    per_segment = restart or n_units
    unit = 0
    for seg in segments:
        buf = seg + b"\x00\x00\x00\x00"
        pos = 0
        pred = {c: 0 for c in comps}
        for _ in range(min(per_segment, n_units - unit)):
            for c, by, bx in blocks_of(unit):
                dc_len, dc_sym, ac_len, ac_sym = luts[c]
                out = coef[c][by, bx]
                b = pos >> 3
                peek = ((buf[b] << 16 | buf[b + 1] << 8 | buf[b + 2]) >> (8 - (pos & 7))) & 0xFFFF
                n = dc_len[peek]
                if not n:
                    raise ValueError("corrupt JPEG: no DC Huffman code matches")
                s = dc_sym[peek]
                pos += n
                v = 0
                if s:
                    b = pos >> 3
                    v = ((buf[b] << 24 | buf[b + 1] << 16 | buf[b + 2] << 8 | buf[b + 3])
                         >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                pred[c] += v
                out[0] = pred[c]
                k = 1
                while k < 64:
                    b = pos >> 3
                    peek = ((buf[b] << 16 | buf[b + 1] << 8 | buf[b + 2]) >> (8 - (pos & 7))) & 0xFFFF
                    n = ac_len[peek]
                    if not n:
                        raise ValueError("corrupt JPEG: no AC Huffman code matches")
                    rs = ac_sym[peek]
                    pos += n
                    r, s = rs >> 4, rs & 15
                    if not s:
                        if r != 15:
                            break
                        k += 16
                        continue
                    k += r
                    b = pos >> 3
                    v = ((buf[b] << 24 | buf[b + 1] << 16 | buf[b + 2] << 8 | buf[b + 3])
                         >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    out[zz[k]] = v
                    k += 1
            unit += 1
        if unit >= n_units:
            break


def parse_jpeg(data):
    """Markers and Huffman decoding on the host: a dict with the frame's
    size, each component's sampling factors, quantisation table and
    coefficients (int32 [block rows, block cols, 64], natural order)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    qt, huff, restart, frame = {}, {}, 0, None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else "u1").astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = vals
                qt[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                symbols = list(body[i + 17:i + 17 + sum(counts)])
                huff[(tc, th)] = _decode_lut(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", body[:6])
            comps = {}
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps[cid] = dict(h=hv >> 4, v=hv & 15, tq=tq, order=k)
            hmax = max(c["h"] for c in comps.values())
            vmax = max(c["v"] for c in comps.values())
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps.values():
                c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32)
            frame = dict(width=w, height=h, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy, comps=comps)
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            kind = "arithmetic-coded" if marker >= 0xC9 else {0xC2: "progressive", 0xC3: "lossless"}.get(
                marker, "extended or hierarchical")
            raise ValueError(f"JPEG SOF{marker - 0xC0} ({kind}) is not read: baseline (SOF0) only")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            ns = body[0]
            scan = [(body[1 + 2 * k], body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15) for k in range(ns)]
            coef, luts = {}, {}
            for cid, td, ta in scan:
                coef[cid] = frame["comps"][cid]["coef"]
                luts[cid] = huff[(0, td)] + huff[(1, ta)]
            if ns == 1:
                c = frame["comps"][scan[0][0]]
                cols = -(-(-(-frame["width"] * c["h"] // frame["hmax"])) // 8)
                rows = -(-(-(-frame["height"] * c["v"] // frame["vmax"])) // 8)
                cid = scan[0][0]
                blocks_of = lambda u: ((cid, u // cols, u % cols),)
                n_units = rows * cols
            else:
                layout = [(cid, dv, dh) for cid, _, _ in scan
                          for dv in range(frame["comps"][cid]["v"]) for dh in range(frame["comps"][cid]["h"])]
                mcux = frame["mcux"]
                blocks_of = lambda u: [(cid, (u // mcux) * frame["comps"][cid]["v"] + dv,
                                        (u % mcux) * frame["comps"][cid]["h"] + dh) for cid, dv, dh in layout]
                n_units = frame["mcux"] * frame["mcuy"]
            segments, pos = _entropy_segments(data, pos + 2 + length)
            _decode_scan(segments, [s[0] for s in scan], blocks_of, restart, n_units, coef, luts)
            continue
        pos += 2 + length
    if frame is None:
        raise ValueError("JPEG: no frame header")
    for c in frame["comps"].values():
        c["q"] = qt[c["tq"]]
    return frame


# jidctint.c's fixed-point constants: FIX(c) = round(c * 2^13)
_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633, c1501=12299,
          c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


def _idct_1d(v, shift):
    """One pass of libjpeg's islow IDCT (jidctint.c, Loeffler-Ligtenberg-
    Moschytz with 13-bit constants) over the eight tensors v, each descaled
    by `shift` bits with rounding."""
    k = _C
    z1 = (v[2] + v[6]) * k["c0541"]
    tmp2 = z1 - v[6] * k["c1847"]
    tmp3 = z1 + v[2] * k["c0765"]
    tmp0, tmp1 = (v[0] + v[4]) << 13, (v[0] - v[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * k["c1175"]
    t0, t1, t2, t3 = t0 * k["c0298"], t1 * k["c2053"], t2 * k["c3072"], t3 * k["c1501"]
    z1, z2 = z1 * -k["c0899"], z2 * -k["c2562"]
    z3, z4 = z3 * -k["c1961"] + z5, z4 * -k["c0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(x + half) >> shift for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit(device):
    """libjpeg's post-IDCT range-limit table, indexed by sample & 1023."""
    t = torch.zeros(1024, dtype=torch.int64, device=device)
    t[:128] = torch.arange(128, 256)
    t[128:512] = 255
    t[896:] = torch.arange(128)
    return t


def _idct_plane(coef, q, rows, cols):
    """Samples [rows, cols] (int64) of one component from its coefficient
    blocks [br, bc, 64] (a tensor on the device): dequantised, libjpeg's
    islow IDCT (columns, then rows), range-limited as libjpeg limits."""
    br, bc = coef.shape[:2]
    x = (coef.reshape(-1, 8, 8).to(torch.int64) * q.reshape(8, 8).to(torch.int64))
    ws = torch.stack(_idct_1d([x[:, r, :] for r in range(8)], 13 - 2), 1)  # PASS1_BITS 2
    out = torch.stack(_idct_1d([ws[:, :, c] for c in range(8)], 13 + 2 + 3), 2)
    samples = _range_limit(coef.device)[out & 1023]
    plane = samples.reshape(br, bc, 8, 8).permute(0, 2, 1, 3).reshape(br * 8, bc * 8)
    return plane[:rows, :cols]


def _fancy_h2(x, rows_too):
    """libjpeg's h2v1 / h2v2 fancy upsampling of an int64 plane, its
    edge columns (and rows) replicated as libjpeg replicates them."""
    if rows_too:
        pad = torch.cat([x[:1], x, x[-1:]], 0)
        up = pad[:-2] + 3 * x  # the nearer row weighs 3, the farther 1
        down = pad[2:] + 3 * x
        colsum = torch.stack([up, down], 1).reshape(2 * x.shape[0], x.shape[1])
        bias_even, bias_odd, shift = 8, 7, 4
    else:
        colsum = x
        bias_even, bias_odd, shift = 1, 2, 2
    p = torch.cat([colsum[:, :1], colsum, colsum[:, -1:]], 1)
    even = (3 * colsum + p[:, :-2] + bias_even) >> shift
    odd = (3 * colsum + p[:, 2:] + bias_odd) >> shift
    return torch.stack([even, odd], 2).reshape(colsum.shape[0], 2 * colsum.shape[1])


def reconstruct(frame, device):
    """The decoded frame, uint8 [H, W, 3] on device, from parse_jpeg's
    coefficients: dequantise, IDCT, upsample, YCbCr -> RGB."""
    w, h, hmax, vmax = frame["width"], frame["height"], frame["hmax"], frame["vmax"]
    planes = []
    for c in sorted(frame["comps"].values(), key=lambda c: c["order"]):
        rows, cols = -(-h * c["v"] // vmax), -(-w * c["h"] // hmax)
        coef = torch.as_tensor(c["coef"], device=device)
        x = _idct_plane(coef, torch.as_tensor(c["q"], device=device), rows, cols)
        fh, fv = hmax // c["h"], vmax // c["v"]
        if (fh, fv) in ((2, 1), (2, 2)) and cols > 2:
            x = _fancy_h2(x, fv == 2)
        elif (fh, fv) != (1, 1):  # libjpeg's plain replication
            x = x.repeat_interleave(fv, 0).repeat_interleave(fh, 1)
        planes.append(x[:h, :w])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)[..., None].expand(h, w, 3).contiguous()
    if len(planes) != 3:
        raise ValueError(f"JPEG with {len(planes)} components: 1 or 3 are read")
    y, cb, cr = planes
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_FIX16(1.40200) * cr + half) >> 16)
    g = y + ((-_FIX16(0.34414) * cb + half - _FIX16(0.71414) * cr) >> 16)
    b = y + ((_FIX16(1.77200) * cb + half) >> 16)
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255).to(torch.uint8)


def jpeg_decode(data, device="cuda"):
    """uint8 [H, W, 3] tensor on device of one baseline JPEG."""
    return reconstruct(parse_jpeg(data), resolve_device(device))


def decode_frames(jpegs, device="cuda"):
    """Decode JPEG payloads to uint8 RGB [H, W, 3] arrays (the pixel work
    on device)."""
    dev = resolve_device(device)
    return [reconstruct(parse_jpeg(j), dev).cpu().numpy() for j in jpegs]
