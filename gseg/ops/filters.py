"""Pre-filtering: Gaussian smoothing and Sobel gradients.

JAX replacement for the reference's OpenCV CUDA filters
(installation.md:33-35 `cudafilters`; Report.pdf p.3 §3.2 pre-filtering,
p.4 §3.2.4 Sobel for the superpixel variant).

Design: separable convolutions expressed as sums of shifted-scaled planes.
Kernel radii are small (radius = ceil(4*sigma), e.g. 4 taps at sigma=0.8), so
2r+1 fused multiply-adds beat conv-dim gymnastics, and XLA fuses
the whole filter into the downstream edge-weight computation. Boundary
handling is replicate ("edge"), matching the Felzenszwalb reference
`convolve_even` clamped-index semantics (official segment.zip filter.h,
reference ref [23]).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def gaussian_kernel_1d(sigma: float):
    """Normalized 1-D Gaussian taps with radius ceil(4*sigma), as a NumPy
    float32 array (static: computed at trace time, baked into the program).

    Matches the reference smoothing width convention (Felzenszwalb
    make_fgauss: len = ceil(sigma*4)+1 half-taps => full radius ceil(4*sigma)).
    """
    import numpy as np

    sigma = max(float(sigma), 1e-2)
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    return (k / np.sum(k)).astype(np.float32)


def _shift_sum_1d(img: jnp.ndarray, taps, axis: int) -> jnp.ndarray:
    """Convolve along `axis` with replicate padding via shifted adds.

    img: (H, W) or (H, W, C) float32. taps: static 1-D tap array.
    """
    radius = (len(taps) - 1) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (radius, radius)
    padded = jnp.pad(img, pad, mode="edge")
    n = img.shape[axis]
    out = jnp.zeros_like(img)
    for i, t in enumerate(taps):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + n)
        out = out + jnp.float32(t) * padded[tuple(sl)]
    return out


def gaussian_smooth(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian smoothing of an (H, W, C) or (H, W) float32 image."""
    img = img.astype(jnp.float32)
    taps = [float(t) for t in gaussian_kernel_1d(sigma)]
    out = _shift_sum_1d(img, taps, axis=0)
    out = _shift_sum_1d(out, taps, axis=1)
    return out


_SOBEL_D = (1.0, 0.0, -1.0)   # derivative taps
_SOBEL_S = (1.0, 2.0, 1.0)    # smoothing taps


def sobel_magnitude(img: jnp.ndarray) -> jnp.ndarray:
    """Sobel gradient magnitude of an image -> (H, W) float32.

    The reference's superpixel variant uses Sobel edge strength in place of
    Structured Forests (Report.pdf p.4 §3.2.4: SF was 20x slower than the
    entire segmentation and had no GPU implementation). Color images are
    reduced to luma first.
    """
    img = img.astype(jnp.float32)
    if img.ndim == 3:
        if img.shape[-1] == 3:
            gray = (
                0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
            )
        else:
            gray = jnp.mean(img, axis=-1)
    else:
        gray = img
    gx = _shift_sum_1d(_shift_sum_1d(gray, _SOBEL_D, axis=1), _SOBEL_S, axis=0)
    gy = _shift_sum_1d(_shift_sum_1d(gray, _SOBEL_D, axis=0), _SOBEL_S, axis=1)
    return jnp.sqrt(gx * gx + gy * gy)
