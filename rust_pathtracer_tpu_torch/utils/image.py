"""Host-side image finishing, PNG input and output, GIF output.

Counterpart of ``rust_pathtracer_tpu/utils/image.py``; plain host code
(numpy and the standard library; no Pillow).  Quantization matches the
reference: gamma 2.0 via sqrt after averaging (renderer.rs:30-31), then
``(v * 255.999) as u8`` with Rust's saturating cast (vec3.rs:278-291).
Images are top row first, as the renderer emits them.
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Sequence

import numpy as np


def gamma_encode(linear: np.ndarray) -> np.ndarray:
    """sqrt gamma (renderer.rs:31); clamps negatives and NaN to 0 first."""
    return np.sqrt(np.maximum(np.nan_to_num(linear, nan=0.0), 0.0))


def quantize_u8(value: np.ndarray) -> np.ndarray:
    """(v * 255.999) with saturating cast (vec3.rs:279-287)."""
    v = np.nan_to_num(np.asarray(value, np.float64), nan=0.0) * 255.999
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def to_rgb8(linear_mean: np.ndarray) -> np.ndarray:
    """Linear mean radiance (H, W, 3) -> gamma-2 RGB8."""
    return quantize_u8(gamma_encode(linear_mean))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel by PNG colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb8: np.ndarray) -> None:
    """8-bit RGB PNG (main.rs:78-91), written with zlib and struct."""
    img = np.ascontiguousarray(rgb8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    # every scanline starts with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()
    png = (_PNG_SIGNATURE
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return
    raise ValueError("truncated PNG file: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) bytes of the scanlines, each filter undone (PNG
    spec 9.2: None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, want {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum of each byte of a pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one to its left
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8, as Pillow's ``convert("RGB")`` gives
    it: grey replicated, the palette looked up, alpha dropped (not
    composited).  Colour types 0, 2, 3, 4 and 6 at bit depth 8, not
    interlaced; any other file raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, palette, idat = None, None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8 is read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced files are read")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: colour type 3 without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# GIF: one median-cut palette for all frames, Floyd-Steinberg dithering, LZW
# ---------------------------------------------------------------------------

GIF_COLORS = 256
_FS_FRAMES = 16  # frames dithered together (a step's arrays stay small)
_LZW_MIN_CODE = 8  # LZW minimum code size: 8-bit palette indices


def median_cut_palette(pixels: np.ndarray) -> np.ndarray:
    """A palette of at most GIF_COLORS entries for ``pixels`` ((N, 3)
    uint8) by median cut: the box of most pixels is split at the median
    pixel of its longest side until there are GIF_COLORS boxes (or no box
    holds two colours); each entry is its box's mean.  Returns (K, 3)
    uint8."""
    packed = (pixels[:, 0].astype(np.int64) << 16 | pixels[:, 1].astype(np.int64) << 8
              | pixels[:, 2])
    uniq, counts = np.unique(packed, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 0xFF, uniq & 0xFF], 1)
    boxes = [np.arange(len(uniq))]
    pop = [int(counts.sum()) if len(uniq) > 1 else -1]  # -1: one colour, no split
    while len(boxes) < GIF_COLORS:
        i = int(np.argmax(pop))
        if pop[i] < 0:
            break
        box = boxes.pop(i)
        pop.pop(i)
        c = cols[box]
        v = c[:, int(np.argmax(c.max(0) - c.min(0)))]
        cum = np.cumsum(np.bincount(v, weights=counts[box], minlength=256))
        median = int(np.searchsorted(cum, cum[-1] / 2.0))
        left = v <= median
        if left.all():  # the median is the largest value: it goes right alone
            left = v < median
        for half in (box[left], box[~left]):
            boxes.append(half)
            pop.append(int(counts[half].sum()) if len(half) > 1 else -1)
    pal = [np.rint((cols[b] * counts[b, None]).sum(0) / counts[b].sum()) for b in boxes]
    return np.clip(np.array(pal), 0, 255).astype(np.uint8)


def dither_floyd_steinberg(frames: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette indices (F, H, W) uint8 of ``frames`` ((F, H, W, 3) uint8)
    with Floyd-Steinberg error diffusion (7/16 right, 3/16, 5/16, 1/16
    below), each value the nearest entry of ``palette`` in RGB.  The
    error reaching pixel (y, x) comes from pixels of earlier anti-
    diagonals x + 2y, so one step handles a whole anti-diagonal of every
    frame at once."""
    f, h, w, _ = frames.shape
    pal = palette.astype(np.float32)
    pal_sq = (pal * pal).sum(1)
    img = frames.astype(np.float32)
    err = np.zeros((f, h + 1, w + 2, 3), np.float32)
    out = np.zeros((f, h, w), np.uint8)
    for t in range(w + 2 * (h - 1)):
        ys = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        xs = t - 2 * ys
        val = np.clip(img[:, ys, xs] + err[:, ys, xs + 1], 0.0, 255.0)
        dist = pal_sq - 2.0 * (val @ pal.T)  # |v - p|^2 less |v|^2
        idx = np.argmin(dist, axis=-1)
        out[:, ys, xs] = idx
        e = val - pal[idx]
        err[:, ys, xs + 2] += e * (7.0 / 16.0)
        err[:, ys + 1, xs] += e * (3.0 / 16.0)
        err[:, ys + 1, xs + 1] += e * (5.0 / 16.0)
        err[:, ys + 1, xs + 2] += e * (1.0 / 16.0)
    return out


def lzw_encode(indices: bytes) -> bytes:
    """GIF's variable-width LZW of ``indices`` (palette indices, one byte
    each) at the minimum code size _LZW_MIN_CODE: codes packed least
    significant bit first, starting at _LZW_MIN_CODE + 1 bits, one bit
    wider once the next free code passes the width, a clear code when the
    table holds 4096 codes, an end code last."""
    clear, end = 1 << _LZW_MIN_CODE, (1 << _LZW_MIN_CODE) + 1
    out = bytearray()
    buf = nbits = 0
    width, next_code, table = _LZW_MIN_CODE + 1, end + 1, {}

    def emit(code):
        nonlocal buf, nbits
        buf |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(buf & 0xFF)
            buf >>= 8
            nbits -= 8

    emit(clear)
    if not indices:
        emit(end)
        if nbits:
            out.append(buf & 0xFF)
        return bytes(out)
    prefix = indices[0]
    for c in indices[1:]:
        k = prefix << 8 | c
        code = table.get(k)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[k] = next_code
            next_code += 1
            if next_code > 1 << width and width < 12:
                width += 1
        else:
            emit(clear)
            table, next_code, width = {}, end + 1, _LZW_MIN_CODE + 1
        prefix = c
    emit(prefix)
    # the decoder adds one more entry on the last code before it reads the end
    if next_code < 4096 and next_code + 1 > 1 << width and width < 12:
        width += 1
    emit(end)
    if nbits:
        out.append(buf & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float, timer=None) -> None:
    """Frames ((H, W, 3) uint8 each) as a looping GIF89a (NETSCAPE2.0, loop
    0) at ``fps``: one 256-colour median-cut palette built from the montage
    of the first, middle and last frame (a fade-in first frame would
    otherwise pin a dark palette on the whole animation), Floyd-Steinberg
    dithering, each frame full size with the delay Pillow writes for
    ``int(1000 / fps)`` ms (the JAX package's recipe; not Pillow's bits).
    With a ``utils.metrics.StageTimer``, its stages "gif palette", "gif
    dither" and "gif lzw" gain the seconds of each step."""
    def stage(name):
        return timer.stage(name) if timer is not None else contextlib.nullcontext()

    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w, _ = frames[0].shape
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError("write_gif: every frame must be (H, W, 3) of one size")
    sample = sorted({0, len(frames) // 2, len(frames) - 1})
    with stage("gif palette"):
        palette = median_cut_palette(
            np.concatenate([frames[i] for i in sample]).reshape(-1, 3))
    table = np.zeros((GIF_COLORS, 3), np.uint8)
    table[:len(palette)] = palette
    delay = int(int(1000.0 / fps) / 10)  # centiseconds
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), table.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for i in range(0, len(frames), _FS_FRAMES):
        with stage("gif dither"):
            group = dither_floyd_steinberg(np.stack(frames[i:i + _FS_FRAMES]), palette)
        for idx in group:
            with stage("gif lzw"):
                data = _sub_blocks(lzw_encode(idx.tobytes()))
            out += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
                    b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                    bytes([_LZW_MIN_CODE]) + data]
    out.append(b"\x3b")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# Image contract between two renders of one configuration that follow
# the same random stream but round differently (another device, another
# library's transcendentals): the means agree within 1% relative, at
# least 90% of pixels agree within 1e-4 * max(1, |reference|) on every
# channel, and nothing is NaN.  A pixel differs where an ulp-level
# difference flipped a discrete choice (hit or miss, reflect or refract)
# on one of its samples, which then takes another path.
IMAGE_MEAN_RTOL = 0.01
IMAGE_PIXEL_TOL = 1e-4
IMAGE_MIN_CLOSE = 0.90


def image_agreement(got: np.ndarray, want: np.ndarray) -> dict:
    """Measure ``got`` against the reference ``want`` (both (H, W, 3)):
    the relative mean error, the fraction of close pixels, whether
    ``got`` has a NaN, and ``ok``, the image contract above."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"image shapes differ: {got.shape} vs {want.shape}")
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    close = (np.abs(got - want) <= IMAGE_PIXEL_TOL * np.maximum(1.0, np.abs(want))
             ).all(axis=-1)
    has_nan = bool(np.isnan(got).any())
    frac_close = float(close.mean())
    return {
        "mean_rel": float(mean_rel),
        "frac_close": frac_close,
        "has_nan": has_nan,
        "ok": mean_rel <= IMAGE_MEAN_RTOL and frac_close >= IMAGE_MIN_CLOSE
        and not has_nan,
    }


def frame_path(output_dir: str, frame_index: int) -> str:
    """./output/image_{:04}.png (main.rs:67)."""
    return os.path.join(output_dir, f"image_{frame_index:04d}.png")
