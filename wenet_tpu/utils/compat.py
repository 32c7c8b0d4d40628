"""Small numeric building blocks of the demod, in plain jnp.

A dense-matmul DFT, a polynomial atan2, a comparison-built floor, and
float32-pair complex transfers.  Each is a pure add/mul/compare
construction with float32 accuracy far beyond the demod's decision
tolerances; the committed golden tables were recorded through them, so
they are used unconditionally on every backend.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=8)
def _dft_tables(n: int):
    k = np.arange(n, dtype=np.float64)
    ang = (-2.0 * np.pi / n) * np.outer(k, k % n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft(x, n_out: int | None = None):
    """Complex DFT along the last axis as ONE real matmul.

    For the modem's sizes (Ndft <= 1024) a dense DFT is one matrix
    product that batches freely and matches jnp.fft.fft to f32 roundoff.
    `n_out` keeps only the first n_out bins (half-spectrum callers skip
    half the FLOPs).

    The real/imag parts are stacked into a single [xr|xi] @ [[C,S],[-S,C]]
    product: four small matmuls + two adds collapse to one op; each output
    is one 2N-term reduction instead of two N-term reductions and an add,
    within f32 roundoff of that form.
    """
    N = x.shape[-1]
    C, S = _dft_tables(N)
    if n_out is not None:
        C, S = C[:, :n_out], S[:, :n_out]
    n_o = C.shape[1]
    Cj, Sj = jnp.asarray(C), jnp.asarray(S)
    T = jnp.concatenate([jnp.concatenate([Cj, Sj], axis=1),
                         jnp.concatenate([-Sj, Cj], axis=1)], axis=0)
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    # HIGHEST precision: a float32 matmul on the GPU may otherwise run in
    # TF32, which would quietly degrade the tone estimator and channelizer
    # DFTs
    y = jnp.matmul(jnp.concatenate([xr, xi], axis=-1), T,
                   precision=jax.lax.Precision.HIGHEST)
    return jax.lax.complex(y[..., :n_o], y[..., n_o:])


@lru_cache(maxsize=1)
def _atan_coeffs():
    """Odd-polynomial least-squares fit of atan on [0, 1]: max |err| < 2e-8
    (beyond f32 resolution).  Deterministic host-side fit."""
    t = np.linspace(0, 1, 4001)
    y = np.arctan(t)
    # atan(t) = t * p(t^2): fit p in s = t^2 with degree 8
    s = (t * t)[1:]
    A = np.vander(s, 9, increasing=True)
    coef, *_ = np.linalg.lstsq(A * t[1:, None], y[1:], rcond=None)
    return tuple(float(c) for c in coef)


def atan2(y, x):
    """Four-quadrant arctangent from polynomial atan (atan2f-accurate)."""
    c = _atan_coeffs()
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    t = lo / jnp.where(hi > 0, hi, 1.0)          # in [0, 1]; 0 when x=y=0
    s = t * t
    p = c[8]
    for k in range(7, -1, -1):
        p = p * s + c[k]
    r = t * p                                     # atan(t)
    r = jnp.where(ay > ax, np.float32(np.pi / 2) - r, r)
    r = jnp.where(x < 0, np.float32(np.pi) - r, r)
    r = jnp.where(y < 0, -r, r)
    return jnp.where(hi > 0, r, 0.0)              # atan2(0,0) = 0


def floor_int(x, lo: int, hi: int):
    """floor(x) as int32 for x known to lie in [lo, hi+1): built from
    comparisons only (no float->int convert_element_type)."""
    out = jnp.full(jnp.shape(x), lo, jnp.int32)
    for k in range(lo + 1, hi + 1):
        out = out + (x >= k).astype(jnp.int32)
    return out


# ------------------------------------------------- complex host<->device IO
#
# Entry points move complex data as float32 (re, im) pairs and form or
# split the complex values on device with lax.complex and .real/.imag.

@jax.jit
def _pairs_to_complex(pairs):
    return jax.lax.complex(pairs[..., 0], pairs[..., 1])


def put_complex(x: np.ndarray) -> jnp.ndarray:
    """Host complex array -> device complex64, transferring only float32."""
    x = np.ascontiguousarray(x, np.complex64)
    pairs = x.view(np.float32).reshape(*x.shape, 2)
    return _pairs_to_complex(jnp.asarray(pairs))


def get_complex(x: jnp.ndarray) -> np.ndarray:
    """Device complex array -> host complex64, transferring only float32."""
    pairs = np.asarray(jnp.stack([x.real, x.imag], axis=-1), np.float32)
    flat = np.ascontiguousarray(pairs).view(np.complex64)
    return flat.reshape(x.shape)
