"""Host-side image finishing and PNG output.

Counterpart of ``rust_pathtracer_tpu/utils/image.py``; plain host code
(numpy and the standard library; no Pillow).  Quantization matches the
reference: gamma 2.0 via sqrt after averaging (renderer.rs:30-31), then
``(v * 255.999) as u8`` with Rust's saturating cast (vec3.rs:278-291).
Images are top row first, as the renderer emits them.
"""

from __future__ import annotations

import os
import struct
import zlib

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
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


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
