"""Scalar-loop NumPy oracle of the reference codec, for test parity only.

This is a deliberately slow, line-by-line-semantics model of the C++
algorithms (compressor.cpp / decompressor.cpp), used to validate the
vectorized jnp transforms bitwise on small inputs.  Intermediate
arithmetic runs in float64 and is rounded to float32 exactly where the C++
stores into ``float`` — the same rounding points as the reference.
"""

from __future__ import annotations

import numpy as np

__all__ = ["haar_forward_oracle", "haar_inverse_oracle", "threshold_oracle"]


def _fwd_line(line32: np.ndarray) -> np.ndarray:
    """Forward pass on one 1D line (compressor.cpp:106-119 semantics)."""
    n = len(line32)
    h = n // 2
    out = line32.copy()
    a = line32[0 : 2 * h : 2].astype(np.float64)
    b = line32[1 : 2 * h : 2].astype(np.float64)
    out[:h] = ((a + b) / 2.0).astype(np.float32)
    out[h : 2 * h] = ((a - b) / 2.0).astype(np.float32)
    # odd n: trailing element untouched
    return out


def _inv_line(line32: np.ndarray) -> np.ndarray:
    """Inverse pass on one 1D line (decompressor.cpp:99-108 semantics):
    double intermediates, trailing odd slot zeroed."""
    n = len(line32)
    h = n // 2
    avg = line32[:h].astype(np.float64)
    diff = line32[h : 2 * h].astype(np.float64)
    out = np.zeros(n, dtype=np.float32)
    out[0 : 2 * h : 2] = (avg + diff).astype(np.float32)
    out[1 : 2 * h : 2] = (avg - diff).astype(np.float32)
    return out


def haar_forward_oracle(box: np.ndarray) -> np.ndarray:
    """box (X, Y, Z) float32 -> flat coefficients float32[X*Y*Z] in the
    reference's flatten order (compressor.cpp:85-185)."""
    t = box.astype(np.float32).copy()
    x, y, z = t.shape
    for i in range(x):           # Z pass
        for j in range(y):
            t[i, j, :] = _fwd_line(t[i, j, :])
    for i in range(x):           # Y pass
        for k in range(z):
            t[i, :, k] = _fwd_line(t[i, :, k])
    for j in range(y):           # X pass
        for k in range(z):
            t[:, j, k] = _fwd_line(t[:, j, k])
    return t.reshape(-1)


def haar_inverse_oracle(flat: np.ndarray, x: int, y: int, z: int) -> np.ndarray:
    """flat float32 coefficients -> box (X, Y, Z) (decompressor.cpp:79-159)."""
    t = np.asarray(flat, dtype=np.float32).reshape(x, y, z).copy()
    for j in range(y):           # X pass
        for k in range(z):
            t[:, j, k] = _inv_line(t[:, j, k])
    for i in range(x):           # Y pass
        for k in range(z):
            t[i, :, k] = _inv_line(t[i, :, k])
    for i in range(x):           # Z pass
        for j in range(y):
            t[i, j, :] = _inv_line(t[i, j, :])
    return t


def threshold_oracle(flat: np.ndarray, keep: float):
    """(mask, values, max_val, thresh) per compressor.cpp:212-234."""
    f = np.asarray(flat, dtype=np.float32)
    idx = int(np.argmax(np.abs(f)))
    max_val = float(np.float64(f[idx]))
    thresh = max_val * (1.0 - float(keep))
    mask = np.abs(f.astype(np.float64)) > thresh
    return mask, f[mask], max_val, thresh
