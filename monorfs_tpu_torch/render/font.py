"""A fixed 5x7 bitmap font for printable ASCII (32-126) and the text of
the port's figures.

The glyphs are the classic 5x7 dot-matrix shapes of the character
generators of early terminals and LCD controllers (the ASCII range of the
HD44780's ROM), which the public-domain X11 misc-fixed "5x7" font also
draws; they are typed here as data. Each glyph is seven rows of five bits,
the leftmost pixel in bit 4; a character advances six columns, a line
nine rows (both times the scale).
"""

import numpy as np

GLYPH_W, GLYPH_H, ADVANCE, LINE = 5, 7, 6, 9

_ROWS = """\
00 00 00 00 00 00 00|04 04 04 04 04 00 04|0A 0A 0A 00 00 00 00|0A 0A 1F 0A 1F 0A 0A
04 0F 14 0E 05 1E 04|18 19 02 04 08 13 03|0C 12 14 08 15 12 0D|0C 04 08 00 00 00 00
02 04 08 08 08 04 02|08 04 02 02 02 04 08|00 04 15 0E 15 04 00|00 04 04 1F 04 04 00
00 00 00 00 0C 04 08|00 00 00 1F 00 00 00|00 00 00 00 00 0C 0C|00 01 02 04 08 10 00
0E 11 13 15 19 11 0E|04 0C 04 04 04 04 0E|0E 11 01 02 04 08 1F|1F 02 04 02 01 11 0E
02 06 0A 12 1F 02 02|1F 10 1E 01 01 11 0E|06 08 10 1E 11 11 0E|1F 01 02 04 08 08 08
0E 11 11 0E 11 11 0E|0E 11 11 0F 01 02 0C|00 0C 0C 00 0C 0C 00|00 0C 0C 00 0C 04 08
02 04 08 10 08 04 02|00 00 1F 00 1F 00 00|08 04 02 01 02 04 08|0E 11 01 02 04 00 04
0E 11 01 0D 15 15 0E|0E 11 11 11 1F 11 11|1E 11 11 1E 11 11 1E|0E 11 10 10 10 11 0E
1C 12 11 11 11 12 1C|1F 10 10 1E 10 10 1F|1F 10 10 1E 10 10 10|0E 11 10 17 11 11 0F
11 11 11 1F 11 11 11|0E 04 04 04 04 04 0E|07 02 02 02 02 12 0C|11 12 14 18 14 12 11
10 10 10 10 10 10 1F|11 1B 15 15 11 11 11|11 11 19 15 13 11 11|0E 11 11 11 11 11 0E
1E 11 11 1E 10 10 10|0E 11 11 11 15 12 0D|1E 11 11 1E 14 12 11|0F 10 10 0E 01 01 1E
1F 04 04 04 04 04 04|11 11 11 11 11 11 0E|11 11 11 11 11 0A 04|11 11 11 15 15 15 0A
11 11 0A 04 0A 11 11|11 11 11 0A 04 04 04|1F 01 02 04 08 10 1F|0E 08 08 08 08 08 0E
00 10 08 04 02 01 00|0E 02 02 02 02 02 0E|04 0A 11 00 00 00 00|00 00 00 00 00 00 1F
08 04 02 00 00 00 00|00 00 0E 01 0F 11 0F|10 10 16 19 11 11 1E|00 00 0E 10 10 11 0E
01 01 0D 13 11 11 0F|00 00 0E 11 1F 10 0E|06 09 08 1C 08 08 08|00 0F 11 11 0F 01 0E
10 10 16 19 11 11 11|04 00 0C 04 04 04 0E|02 00 06 02 02 12 0C|10 10 12 14 18 14 12
0C 04 04 04 04 04 0E|00 00 1A 15 15 11 11|00 00 16 19 11 11 11|00 00 0E 11 11 11 0E
00 00 1E 11 1E 10 10|00 00 0D 13 0F 01 01|00 00 16 19 10 10 10|00 00 0E 10 0E 01 1E
08 08 1C 08 08 09 06|00 00 11 11 11 13 0D|00 00 11 11 11 0A 04|00 00 11 11 15 15 0A
00 00 11 0A 04 0A 11|00 00 11 11 0F 01 0E|00 00 1F 02 04 08 1F|02 04 04 08 04 04 02
04 04 04 04 04 04 04|08 04 04 02 04 04 08|00 00 08 15 02 00 00"""

# GLYPHS[c - 32]: bool [7, 5] of character c
GLYPHS = np.array([
    [[(int(r, 16) >> (4 - b)) & 1 for b in range(GLYPH_W)] for r in g.split()]
    for line in _ROWS.splitlines() for g in line.split("|")
], dtype=bool)


def text_size(s, scale=1):
    """(width, height) in pixels of a one-line string."""
    return max(len(s) * ADVANCE - 1, 0) * scale, GLYPH_H * scale


def text_pixels(s, x, y, scale=1, anchor="lt"):
    """Pixel (rows, cols) lit by string s, int64 arrays. The anchor's first
    letter places x (l, c, r: left, centre, right), its second y (t, m, b:
    top, middle, bottom); characters outside 32-126 draw as '?'."""
    w, h = text_size(s, scale)
    x0 = x - {"l": 0, "c": w / 2, "r": w}[anchor[0]]
    y0 = y - {"t": 0, "m": h / 2, "b": h}[anchor[1]]
    x0, y0 = int(round(x0)), int(round(y0))
    codes = np.array([ord(c) if 32 <= ord(c) <= 126 else ord("?") for c in s], np.int64) - 32
    if not len(codes):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k, r, c = np.nonzero(GLYPHS[codes])
    sub = np.arange(scale)
    rows = (y0 + r[:, None, None] * scale + sub[None, :, None] + 0 * sub[None, None, :]).ravel()
    cols = (x0 + (k * ADVANCE + c)[:, None, None] * scale + 0 * sub[None, :, None]
            + sub[None, None, :]).ravel()
    return rows.astype(np.int64), cols.astype(np.int64)
