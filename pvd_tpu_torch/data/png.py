"""PNG files with no image library: `zlib` and `struct` only.

The counterpart of the JAX package's `cv2.imread` / `cv2.imwrite` calls
(data/provider.py:33-43, data/synth.py:115, engine/trainer.py:1079-1082),
for machines without cv2.  Pixels are in the file's own channel order,
R, G, B(, A): cv2's BGR swaps have no counterpart here.

`read_png` takes 8-bit greyscale, greyscale + alpha, RGB and RGBA, not
interlaced, with any of the five scanline filters; anything else (a
palette, 1-, 2-, 4- or 16-bit samples, Adam7 interlacing) raises
ValueError naming what the file holds.  `write_png` writes 8-bit grey,
RGB and RGBA with filter type 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit types read here
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type, for writing


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without IEND")


def _unfilter_rows(rows: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Filters None, Sub and Up only: one vectorised step per row (Sub is
    a running sum along the row, Up adds the row above, mod 256)."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1:], np.uint8)
    for y, t in enumerate(ftype):
        if t == 1:
            out[y] = np.cumsum(rows[y], axis=0, dtype=np.uint8)
        elif t == 2:
            out[y] = rows[y] + prev
        else:
            out[y] = rows[y]
        prev = out[y]
    return out


def _unfilter(rows: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the scanline filters of rows [H, W, C] (uint8, one pixel = C
    bytes at 8 bits) with filter types ftype [H].

    Each filter predicts a byte from a (the byte one pixel left), b (the
    byte above) and c (above-left).  Without Average and Paeth rows the
    image is undone row by row.  Otherwise the reconstruction of pixel
    (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), so all pixels of an
    anti-diagonal y + x = d are reconstructed together, in H + W - 1
    vectorised passes over a copy skewed so that each anti-diagonal is
    one contiguous slice: R[d + 2, y + 1] holds pixel (y, d - y), and the
    padding row and column, and every slot off the image, stay zero."""
    top = int(ftype.max(initial=0))
    if top > 4:
        raise ValueError(f"unknown PNG filter type {top}")
    if top <= 2:
        return _unfilter_rows(rows, ftype)
    H, W, C = rows.shape
    yy, xx = np.mgrid[0:H, 0:W]
    filt = np.zeros((H + W - 1, H, C), np.int32)
    filt[yy + xx, yy] = rows
    R = np.zeros((H + W + 1, H + 1, C), np.int32)
    # per row, 1 where its filter is Sub, Up, Average, Paeth
    sub, up, avg, paeth_row = ((ftype == k).astype(np.int32)[:, None]
                               for k in (1, 2, 3, 4))
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        a, b, c = R[d + 1, lo + 1:hi + 1], R[d + 1, lo:hi], R[d, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (sub[lo:hi] * a + up[lo:hi] * b
                + avg[lo:hi] * ((a + b) >> 1) + paeth_row[lo:hi] * paeth)
        R[d + 2, lo + 1:hi + 1] = (filt[d, lo:hi] + pred) & 0xFF
    return R[yy + xx + 2, yy + 1].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """[H, W, C] uint8 of an 8-bit PNG: C = 1 (grey), 2 (grey + alpha),
    3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"{path}: PNG with bit depth {depth} and colour "
                         f"type {color}; only 8-bit grey, grey + alpha, RGB "
                         "and RGBA are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG (Adam7) is not read")
    C = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{H * (1 + W * C)}")
    raw = raw.reshape(H, 1 + W * C)
    return _unfilter(raw[:, 1:].reshape(H, W, C), raw[:, 0])


def write_png(path, img: np.ndarray) -> None:
    """Write [H, W] or [H, W, C] uint8, C in (1, 3, 4): grey, RGB, RGBA."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in \
            _COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 [H, W(, 1|3|4)], got "
                         f"{img.dtype} {img.shape}")
    H, W, C = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(H, W * C)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                             _COLOR_TYPE[C], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))
