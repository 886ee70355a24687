"""A small RGB raster canvas written as PNG with numpy and zlib: lines,
markers, filled rectangles and polygons, and text in a 7x14 bitmap font
(DejaVu Sans Mono rendered at 9 pt and thresholded; printable ASCII).

The port's plots (:mod:`.plot`) draw on it, so they need neither
matplotlib nor an imaging library where the port runs.
"""

from __future__ import annotations

import base64
import struct
import zlib

import numpy as np

GLYPH_W, GLYPH_H = 7, 14
_FONT_B64 = (
    "AAAAAAAAAAAAAAAAAAAgQIECBAAAIAAAAAAUKFAAAAAAAAAAAAACxQp/SLP0iwAAAAAAA8wQ"
    "HBwNG+AAAAAAwECGYxuFGhwAAAAAHGBAwpSp0Z0AAAAAAgQIAAAAAAAAAAAAECCBAgQIECAg"
    "QAAAICBAwIECDBAggAAAAAQqOHFQgAAAAAAAAAAACBD8QIEAAAAAAAAAAAAAAAAwYIEAAAAA"
    "AAAADgAAAAAAAAAAAAAAAAAGDAAAAAAAAIEGCDBBggwQIAAA4yRq1aNGyOAAAAAAcGDBgwYM"
    "GHwAAAAAHiIECDDDDB8AAAAAB4CBHgQIGCfAAAAAADDhxZsmfhgwAAAAAHzBg8BAwYJ4AAAA"
    "AA8wQPmSNGyPAAAAAAfggQYIMECDAAAAAADzJEyPIkaM8AAAAAA4yRo2Z8GGeAAAAAAAADBg"
    "AAAGDAAAAAAAAAAYMAABgwQYAAAAACOcMBwMAAAAAAAAAAAH4AA/AAAAAAAAAEDgOHOIAAAA"
    "AAAAA8CBBhggQAEAAAAAAeZoR4kyJHoGA4AAADDhwsSZP0aEAAAAAD5EjRPkaFG+AAAAAAHE"
    "GCBAgYEBwAAAAAHiZGjRo0aZ4AAAAAD9gwYP2DBg/AAAAAA/YMGD5gwYMAAAAAADzBAgTo0b"
    "M8AAAAABGjRo36NGjRgAAAAA+ECBAgQIEPgAAAAADwIECBAgyZ4AAAAABGmWOHCRMjQgAAAA"
    "AwYMGDBgwYPwAAAAAI2bdqtUoUKEAAAAABmzdq1adOnRgAAAAAPMkaNCjRsjwAAAAAPmbFm+"
    "YMGDAAAAAAA8yRo0KNGyPBgAAAAeIkaJ4mRI0IAAAAADzBAwPAwaN8AAAAAD8QIECBAgQIAA"
    "AAAARo0aNGjRsjwAAAAAIUaNkSLFDgwAAAAAAGCtWrW7dkyAAAAAAjZFhgw4SRoQAAAAAIUR"
    "Y4MECBAgAAAAAD8GCCDBBBg/AAAAAAHCBAgQIECBAgcAAAACBgQICBAwIGBAAABwIECBAgQI"
    "ECHAAAQcJIwAAAAAAAAAAAAAAAAAAAAAAAAAfyBgQAAAAAAAAAAAAAAAAAHwIGfRo34AAAAQ"
    "IED5kzRs2T4AAAAAAAAOIMGDAgOAAAAACBAjzZEiRNjwAAAAAAAA8yRv0DA8AAAAA4gQ/ECB"
    "AgQIAAAAAAAADzJEiRMjwIEcAYMGD5kzZs2bMAAAABgAAcGDBgwY/AAAAAIAAHAgQIECBAgx"
    "wAMGDBm2ePGzJiAAAADgQIECBAgQIHAAAAAAAAHy1SpUqVIAAAAAAAD5kzZs2bMAAAAAAAAP"
    "MkaNGyPAAAAAAAAPmTNGzZPkCBAAAAAA+zRo0bM+DBgwAAAAfMGDBgwYAAAAAAAAHmDA8CBP"
    "gAAAAABAh8IECBAgcAAAAAAAAzZs2bNmfAAAAAAAAEaJkWKHBgAAAAAAAAHCpWt2zIAAAAAA"
    "AAjLHBhxkjAAAAAAAAEKNkSODBggQwAAAAD4EEGGGD4AAAAAAYYMGCHAgYMGDAwAQIECBAgQ"
    "IECBAgAAAOBAgQMDDBAgQIcAAAAAAAOQ4AAAAAAA"
)
_GLYPHS = np.unpackbits(np.frombuffer(base64.b64decode(_FONT_B64), np.uint8))[
    :95 * GLYPH_H * GLYPH_W].reshape(95, GLYPH_H, GLYPH_W).astype(bool)


def rgb(color: str) -> np.ndarray:
    """'#RRGGBB' -> (3,) float RGB in 0..255."""
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], float)


class Canvas:
    """An (height, width) RGB image, white, with (col, row) pixel
    coordinates (row 0 at the top)."""

    def __init__(self, width: int, height: int):
        self.img = np.full((height, width, 3), 255.0)

    @property
    def shape(self):
        return self.img.shape[:2]

    def put(self, cols, rows, color, alpha: float = 1.0) -> None:
        """Paint pixels (integer arrays), clipped to the image."""
        h, w = self.shape
        cols, rows = np.asarray(cols).ravel(), np.asarray(rows).ravel()
        ok = (cols >= 0) & (cols < w) & (rows >= 0) & (rows < h)
        r, c = rows[ok], cols[ok]
        self.img[r, c] = (1 - alpha) * self.img[r, c] + alpha * rgb(color)

    def line(self, xs, ys, color, width: int = 1) -> None:
        """A polyline through pixel points; a non-finite point breaks it."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        off = np.arange(width) - (width - 1) // 2
        for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
            if not np.isfinite([x0, y0, x1, y1]).all():
                continue
            n = int(max(abs(x1 - x0), abs(y1 - y0))) + 2
            t = np.linspace(0.0, 1.0, n)
            c = np.rint(x0 + t * (x1 - x0)).astype(int)
            r = np.rint(y0 + t * (y1 - y0)).astype(int)
            for o in off:
                self.put(c + o, r, color)
                self.put(c, r + o, color)

    def marker(self, x, y, shape: str, color, size: int = 4) -> None:
        """A filled marker ('o', 's', '^', 'D') with a white rim."""
        for rad, col in ((size + 1, "#FFFFFF"), (size, color)):
            d = np.arange(-rad, rad + 1)
            dx, dy = np.meshgrid(d, d)
            mask = {"o": dx * dx + dy * dy <= rad * rad,
                    "s": np.ones_like(dx, bool),
                    "^": 2 * np.abs(dx) <= dy + rad,
                    "D": np.abs(dx) + np.abs(dy) <= rad}[shape]
            for cx, cy in zip(np.atleast_1d(x), np.atleast_1d(y)):
                if np.isfinite([cx, cy]).all():
                    self.put(int(round(cx)) + dx[mask], int(round(cy)) + dy[mask],
                             col)

    def rect(self, x0, y0, x1, y1, color, alpha: float = 1.0) -> None:
        c0, c1 = sorted((int(round(x0)), int(round(x1))))
        r0, r1 = sorted((int(round(y0)), int(round(y1))))
        cc, rr = np.meshgrid(np.arange(c0, c1 + 1), np.arange(r0, r1 + 1))
        self.put(cc, rr, color, alpha)

    def polygon(self, xs, ys, color, alpha: float = 1.0) -> None:
        """Fill the polygon through pixel points (even-odd rule)."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        cc, rr = np.meshgrid(np.arange(int(xs.min()), int(xs.max()) + 1),
                             np.arange(int(ys.min()), int(ys.max()) + 1))
        inside = np.zeros(cc.shape, bool)
        for i in range(len(xs)):
            xa, ya, xb, yb = xs[i - 1], ys[i - 1], xs[i], ys[i]
            cross = (ya > rr) != (yb > rr)
            with np.errstate(divide="ignore", invalid="ignore"):
                xi = xa + (rr - ya) * (xb - xa) / (yb - ya)
            inside ^= cross & (cc < xi)
        self.put(cc[inside], rr[inside], color, alpha)

    def text(self, x, y, s: str, color="#333333", anchor: str = "left") -> None:
        """Text with its top-left (anchor 'left'), top-centre ('center')
        or top-right ('right') at pixel (x, y)."""
        w = GLYPH_W * len(s)
        x0 = int(round(x - {"left": 0, "center": w / 2, "right": w}[anchor]))
        for i, ch in enumerate(s):
            code = ord(ch) - 32
            if not 0 <= code < 95:
                code = ord("?") - 32
            r, c = np.nonzero(_GLYPHS[code])
            self.put(x0 + i * GLYPH_W + c, int(round(y)) + r, color)

    def save_png(self, path: str) -> str:
        """Write the image as an 8-bit RGB PNG."""
        img = np.clip(np.rint(self.img), 0, 255).astype(np.uint8)
        h, w = self.shape
        raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

        def chunk(tag: bytes, data: bytes) -> bytes:
            return (struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                 0))
                    + chunk(b"IDAT", zlib.compress(raw, 6))
                    + chunk(b"IEND", b""))
        return path
