"""PNG writer and reader with the standard library only (zlib), for the
port's rendered frames: 8-bit RGB, one IDAT, CRCs from zlib.crc32. The
reader takes what the writer writes (8-bit RGB, row filter 0), so that a
frame can be read back where PIL is missing, as on the card's machine."""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(image):
    """PNG bytes of a uint8 [H, W, 3] array (filter 0 on every row)."""
    img = np.ascontiguousarray(np.asarray(image, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], not {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path_or_file, image):
    """Write a uint8 [H, W, 3] array (numpy or a tensor on any device) as
    an 8-bit RGB PNG; returns the number of bytes written."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    data = encode_png(image)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)
    return len(data)


def read_png(path_or_file):
    """uint8 [H, W, 3] of a PNG that write_png wrote."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat += payload
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"PNG depth {depth}, colour type {ctype}, interlace {interlace}: "
                         "read_png reads 8-bit RGB only, as write_png writes it")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"PNG row filter {int(rows[rows[:, 0] != 0, 0][0])}: read_png reads filter 0 only, "
                         "as write_png writes it")
    return rows[:, 1:].reshape(h, w, 3).copy()
