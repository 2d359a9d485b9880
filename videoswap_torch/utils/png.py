"""PNG read and write on the standard library's zlib (the card's machine
may have no PIL, and the port must still read a frame directory there).

`read_png` takes 8-bit gray, RGB and RGBA images, not interlaced, with
any of the five row filters; `write_png` writes 8-bit gray, RGB or RGBA
with filter 0 (none) on every row. `read_image` reads
PNGs here and any other format through PIL, imported when it is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}             # color type -> channels


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f'PNG data holds {rows.size} bytes, expected '
                         f'{height * (stride + 1)}')
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = filt
        elif kind == 1:       # sub: a running sum per byte of a pixel
            cur = np.cumsum(filt.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:       # up
            cur = filt + prior
        elif kind == 3:
            cur = np.frombuffer(_average_row(filt.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(filt.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f'PNG row {y}: unknown filter type {kind}')
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for gray, (H, W, C) for RGB and RGBA."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f'{path}: not a PNG file')
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f'{path}: bit depth {depth}, color type {color}, interlace '
            f'{interlace}: only 8-bit gray, RGB and RGBA without interlace '
            'are read')
    c = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b''.join(idat)), height, width * c, c)
    return px.reshape(height, width, c) if c > 1 else px.reshape(height,
                                                                 width)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write (H, W) gray or (H, W, 3 or 4) uint8 as a PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8, not {img.dtype}')
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if img.ndim != 3 or color is None:
        raise ValueError(f'write_png takes (H, W), (H, W, 3) or (H, W, 4), '
                         f'not {image.shape}')
    h, w = img.shape[:2]
    rows = np.zeros((h, w * c + 1), np.uint8)
    rows[:, 1:] = img.reshape(h, w * c)
    with open(path, 'wb') as f:
        f.write(_SIGNATURE
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color,
                                              0, 0, 0))
                + _chunk(b'IDAT', zlib.compress(rows.tobytes(), level))
                + _chunk(b'IEND', b''))


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB: PNGs here, other formats
    through PIL."""
    with open(path, 'rb') as f:
        is_png = f.read(len(_SIGNATURE)) == _SIGNATURE
    if is_png:
        img = read_png(path)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f'{path} is not a PNG: reading it needs PIL '
                          '(pillow)') from e
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.uint8)
