"""Dependency-free PNG/PPM image I/O (SURVEY.md C2 replacement).

The reference displays frames through CUDA->OpenGL interop (SURVEY.md L4);
on a headless accelerator host the display layer becomes "return the array / write an image
file". Pure-Python PNG codec (zlib from the stdlib) so no extra deps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W, 3) float [0,1] or uint8, or (H, W) grayscale, as PNG
    bytes (in-memory form of write_png — used by the interactive viewer)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        img = img[:, :, None]
    elif img.shape[2] == 1:
        color_type = 0
    elif img.shape[2] == 2:  # gray + alpha
        color_type = 4
    elif img.shape[2] == 3:
        color_type = 2
    elif img.shape[2] == 4:
        color_type = 6
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float [0,1] or uint8, or (H, W) grayscale, as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_apng(path: str, frames: np.ndarray, fps: float = 24.0) -> None:
    """Write an (F, H, W, 3) stack as an animated PNG (APNG, loops forever).

    Single-file animation export for flythrough stacks (SURVEY.md C8/L4):
    APNG is plain PNG chunks (acTL/fcTL/fdAT), so this stays stdlib-only
    and every browser plays it with a bare <img> tag.
    """
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"want (F, H, W, 3), got {frames.shape}")
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    nf, h, w = frames.shape[:3]
    delay_den = max(int(round(fps)), 1)
    seq = 0

    def fctl(seq, w, h):
        return _chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, 1, delay_den, 0, 0))

    out = [_PNG_SIG,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           _chunk(b"acTL", struct.pack(">II", nf, 0))]
    for fi in range(nf):
        raw = b"".join(b"\x00" + frames[fi, y].tobytes() for y in range(h))
        data = zlib.compress(raw, 6)
        out.append(fctl(seq, w, h))
        seq += 1
        if fi == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_png16(path: str, img: np.ndarray) -> None:
    """Write (H, W) float [0,1] or uint16 grayscale as 16-bit PNG
    (lossless heightmap export)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"write_png16 wants (H, W), got {img.shape}")
    if img.dtype != np.uint16:
        img = (np.clip(img, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    h, w = img.shape
    be = img.astype(">u2")
    raw = b"".join(b"\x00" + be[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        line = raw[pos + 1: pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pr) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read PNG -> (H, W, C) uint8/uint16.

    Supports 8/16-bit gray/gray+alpha/RGB/RGBA and palette (PLTE) images
    at bit depth 1/2/4/8 (palette expands to RGB, or RGBA when a tRNS
    chunk is present). Interlacing is not supported.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr, plte, trns = 8, b"", None, None, None
    while pos < len(data):
        # untrusted-input gate: chunk header and body must be fully
        # present, or a truncated file surfaces as opaque struct/
        # unpack errors (or a None IHDR TypeError) instead of this
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (chunk header at "
                             f"{pos} past EOF {len(data)})")
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        if pos + 8 + length > len(data):
            raise ValueError(f"{path}: truncated PNG ({tag!r} chunk body "
                             f"{length}B at {pos + 8} past EOF {len(data)})")
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: corrupt PNG (no IHDR chunk)")
    w, h, depth, color_type, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG not supported")
    paletted = color_type == 3
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"unsupported PNG color type {color_type}")
    if paletted:
        if plte is None or len(plte) % 3:
            raise ValueError(f"{path}: paletted PNG without a valid PLTE")
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"unsupported palette bit depth {depth}")
    elif depth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    bpp = max(channels * depth // 8, 1)
    stride = (w * channels * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG (IDAT inflate: {e})") from None
    # untrusted input gate: the scanline buffer must be exactly
    # h * (1 filter byte + stride) long, or the (native C++) unfilter
    # would read out of bounds on a truncated/corrupt IDAT stream
    expect = h * (stride + 1)
    if raw.shape[0] != expect:
        raise ValueError(
            f"{path}: corrupt PNG — IDAT inflates to {raw.shape[0]} bytes, "
            f"IHDR implies {expect} ({h} rows x (1 + {stride}))")
    # native unfilter when available (pure-Python fallback is interpreter-
    # speed: minutes for an 8192^2 DEM)
    from hmrt.io import native as _native
    flat = _native.png_unfilter(raw, h, stride, bpp)
    if flat is None:
        flat = _unfilter(raw, h, stride, bpp)
    if paletted:
        rows = flat.reshape(h, stride)
        if depth < 8:
            bits = np.unpackbits(rows, axis=1)
            per = 8 // depth
            idx = bits.reshape(h, stride * per, depth)
            weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
            idx = (idx * weights).sum(axis=2).astype(np.uint8)[:, :w]
        else:
            idx = rows[:, :w]
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if idx.max() >= pal.shape[0]:
            raise ValueError(f"{path}: palette index out of range")
        img = pal[idx]                       # (H, W, 3)
        if trns is not None:
            alpha = np.full(pal.shape[0], 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
            img = np.concatenate([img, alpha[idx][..., None]], axis=2)
        return img
    if depth == 16:
        img = flat.reshape(h, w, channels, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = flat.reshape(h, w, channels)
    return img


def read_png_gray(path: str) -> np.ndarray:
    """Read PNG -> float32 (H, W) luminance."""
    img = read_png(path).astype(np.float32)
    if img.shape[2] == 1:
        return img[:, :, 0]
    if img.shape[2] == 2:  # gray + alpha
        return img[:, :, 0]
    return img[:, :, 0] * 0.299 + img[:, :, 1] * 0.587 + img[:, :, 2] * 0.114


def write_ppm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img[:, :, :3].tobytes())
