"""Streaming per-pixel noise estimation (Welch PSD high-frequency floor).

The reference estimates each pixel's noise sigma as the square root of the
mean one-sided Welch PSD over the upper-frequency half-band, computed one
pixel-trace at a time under ``vmap`` with ``jax.scipy.signal.welch``
(reference preprocessing_utils.py:28-40). We reimplement Welch directly as a
single batched segment/rfft program over a ``(pixels, T)`` tile so the whole
spatial tile is one XLA program: strided segment gather -> per-segment
constant detrend -> periodic Hann window -> rfft -> scaled periodogram ->
segment average -> band mean -> sqrt. This removes the per-pixel vmap of a
host-level scipy port and keeps everything fusible.

Welch parameters are pinned to the reference call signature
(``welch(trace, noverlap=128)`` with scipy defaults): fs=1, nperseg=256,
noverlap=128, hann(sym=False), detrend='constant', one-sided density scaling.
The averaged band is bins [nperseg/4 + 1, nperseg/2 + 1) x 0.5 — including
the reference's (slight) Nyquist-bin inclusion — so numbers match exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array

NPERSEG = 256
NOVERLAP = 128
_STEP = NPERSEG - NOVERLAP
_BAND_START = NPERSEG // 4 + 1   # 65
_BAND_END = NPERSEG // 2 + 1     # 129 (exclusive)


def _hann_periodic(n: int, dtype) -> Array:
    i = jnp.arange(n, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * i / n)


def _band_dft_matrices(dtype, nperseg: int = NPERSEG):
    """Windowed real-DFT matrices for bins [_BAND_START, _BAND_END) only.

    Only 64 of the rfft bins are needed, so they are evaluated as two
    (nperseg, n_bins) matmuls instead of a full FFT (whether cuFFT plus a
    band slice is faster on the H100 is not measured). The Hann window is folded
    into the matrices; constant detrend folds in as a rank-1 correction
    (F @ (w*(x - m)) = F_w @ x - m * (F_w @ 1)).

    ``nperseg`` is the segment/transform length: 256 for the documented
    scipy semantics; the full trace length for the reference-compat mode
    (see :func:`welch_noise_estimate_ref_compat`). The band indices stay
    [65, 129) either way — that is the reference's hardcoded arithmetic.
    """
    n = jnp.arange(nperseg, dtype=dtype)[:, None]
    k = jnp.arange(_BAND_START, _BAND_END, dtype=dtype)[None, :]
    ang = (-2.0 * jnp.pi / nperseg) * n * k
    win = _hann_periodic(nperseg, dtype)[:, None]
    cos_m = jnp.cos(ang) * win                       # (nperseg, n_bins)
    sin_m = jnp.sin(ang) * win
    return cos_m, sin_m, cos_m.sum(axis=0), sin_m.sum(axis=0)


@jax.jit
def welch_noise_estimate(traces: Array) -> Array:
    """Per-trace noise sigma for ``traces`` of shape (..., T), T >= 256.

    Returns shape (...,): sqrt(mean of one-sided Welch PSD x 0.5 over the
    upper half-band), matching reference ``get_noise_estimate``
    (reference preprocessing_utils.py:28-37) per trace. Implemented as a
    windowed partial DFT by matmul (see _band_dft_matrices) rather than
    rfft — identical arithmetic restricted to the needed bins.
    """
    t = traces.shape[-1]
    if t < NPERSEG:
        raise ValueError(f"welch_noise_estimate needs at least {NPERSEG} frames, got {t}")
    dtype = jnp.promote_types(traces.dtype, jnp.float32)
    traces = traces.astype(dtype)

    n_segs = (t - NPERSEG) // _STEP + 1
    starts = jnp.arange(n_segs) * _STEP                          # (S,)
    seg_idx = starts[:, None] + jnp.arange(NPERSEG)[None, :]     # (S, nperseg)
    segs = traces[..., seg_idx]                                   # (..., S, nperseg)

    cos_m, sin_m, cos_1, sin_1 = _band_dft_matrices(dtype)
    m = jnp.mean(segs, axis=-1, keepdims=True)                    # detrend='constant'
    # full f32 precision: sigma feeds the global standardization, where a
    # reduced-precision (bf16/TF32) product would put a ~1e-3 floor under
    # every parity bar
    hi = jax.lax.Precision.HIGHEST
    re = jnp.matmul(segs, cos_m, preferred_element_type=jnp.float32,
                    precision=hi) - m * cos_1
    im = jnp.matmul(segs, sin_m, preferred_element_type=jnp.float32,
                    precision=hi) - m * sin_1

    # density scaling: 1 / (fs * sum(win^2)); one-sided doubling then the
    # reference's x0.5 cancel for interior bins, so apply neither and keep
    # the Nyquist bin un-halved exactly as the reference arithmetic does:
    # psd_onesided[k] = 2*|X|^2*scale for 0<k<nyq; ref multiplies by 0.5.
    # psd_onesided[nyq] = |X|^2*scale; ref multiplies by 0.5.
    win = _hann_periodic(NPERSEG, dtype)
    scale = 1.0 / jnp.sum(win * win)
    p = (re * re + im * im) * scale                               # (..., S, n_bins)
    band = jnp.mean(p, axis=-2)                                   # average over segments
    # Halve only the Nyquist bin (reference applies 0.5 to doubled one-sided
    # values; our p is the two-sided value = onesided*0.5 already, except at
    # Nyquist where onesided == p, so ref's 0.5*onesided = 0.5*p there).
    band = band.at[..., -1].multiply(0.5)
    return jnp.sqrt(jnp.mean(band, axis=-1))


@jax.jit
def welch_noise_estimate_ref_compat(traces: Array) -> Array:
    """Per-trace noise sigma reproducing the reference's *effective* output.

    The reference calls ``jax.scipy.signal.welch(trace, noverlap=128)`` with
    ``nperseg`` unspecified and hardcodes band indices for nperseg=256
    (reference preprocessing_utils.py:28-37) — but jax's ``_triage_segments``
    sets ``nperseg = len(trace)`` when unspecified, so the reference actually
    computes ONE full-length Hann periodogram per trace and averages bins
    [65, 129) of the T-point one-sided density PSD (a *mid*-frequency band
    for the usual 1024-frame stats chunks, not the documented upper half).
    This kernel reproduces that arithmetic in closed form, batched over
    (..., T): constant detrend, full-length Hann window, partial DFT at bins
    65..128 by matmul, density scaling, one-sided doubling for interior bins
    (the reference's x0.5 then cancels it), Nyquist-bin halving only when
    T == 256. Verified to match jax-welch to f32 roundoff at T in
    {256, 300, 512, 1024}.
    """
    t = traces.shape[-1]
    if t < 2 * (_BAND_END - 1):
        raise ValueError(
            f"reference-compat noise estimate needs at least "
            f"{2 * (_BAND_END - 1)} frames, got {t}"
        )
    dtype = jnp.promote_types(traces.dtype, jnp.float32)
    traces = traces.astype(dtype)

    cos_m, sin_m, cos_1, sin_1 = _band_dft_matrices(dtype, nperseg=t)
    m = jnp.mean(traces, axis=-1, keepdims=True)
    hi = jax.lax.Precision.HIGHEST
    re = jnp.matmul(traces, cos_m, preferred_element_type=jnp.float32,
                    precision=hi) - m * cos_1
    im = jnp.matmul(traces, sin_m, preferred_element_type=jnp.float32,
                    precision=hi) - m * sin_1

    win = _hann_periodic(t, dtype)
    scale = 1.0 / jnp.sum(win * win)
    p = (re * re + im * im) * scale                  # two-sided density value
    # one-sided doubling (k < t/2) x reference 0.5 -> 1; Nyquist (k == t/2,
    # only reachable at t == 256) stays undoubled -> 0.5
    k = jnp.arange(_BAND_START, _BAND_END)
    mult = jnp.where(2 * k < t, 1.0, 0.5).astype(dtype)
    band = p * mult
    return jnp.sqrt(jnp.mean(band, axis=-1))


@jax.jit
def get_mean_and_noise_ref_compat(
    movie: Array, mean_divisor: int | Array
) -> Tuple[Array, Array]:
    """Chunk mean + reference-effective noise sigma (see
    :func:`welch_noise_estimate_ref_compat`)."""
    partial_mean = jnp.sum(movie, axis=2) / mean_divisor
    noise = welch_noise_estimate_ref_compat(movie)
    return partial_mean, noise


@jax.jit
def get_mean_and_noise(movie: Array, mean_divisor: int | Array) -> Tuple[Array, Array]:
    """Chunk contribution to the running mean + per-pixel noise sigma.

    ``movie``: (d1, d2, T) chunk. The mean term is ``sum over frames /
    mean_divisor`` (divisor = total frames in the FULL movie, so chunk
    contributions sum to the global mean) — parity with reference
    ``get_mean_and_noise`` (reference preprocessing_utils.py:10-20).
    """
    partial_mean = jnp.sum(movie, axis=2) / mean_divisor
    noise = welch_noise_estimate(movie)   # batched over (d1, d2)
    return partial_mean, noise


@jax.jit
def get_mean_chunk(movie: Array, mean_divisor: int | Array) -> Array:
    """Mean-only chunk contribution (short chunks skip the noise estimate,
    reference pmd_loader.py:276-280)."""
    return jnp.sum(movie, axis=2) / mean_divisor


# -- small per-trace preprocessing helpers (reference preprocessing_utils.py
#    :43-94 parity; batched over leading dims instead of per-trace vmap) ------


# reference-name aliases (preprocessing_utils.py:28, :60); the batched
# implementations accept a single (T,) trace as the degenerate batch
get_noise_estimate = welch_noise_estimate


@jax.jit
def get_mean(trace: Array) -> Array:
    """Per-trace mean (reference preprocessing_utils.py:60-62)."""
    return jnp.mean(trace, axis=-1)


@jax.jit
def center(traces: Array) -> Array:
    """Subtract each trace's mean: (..., T) -> (..., T)."""
    return traces - jnp.mean(traces, axis=-1, keepdims=True)


@jax.jit
def center_and_noise_normalize(traces: Array) -> Array:
    """Center each trace and divide by its Welch noise sigma (reference
    preprocessing_utils.py:73-81). Requires T >= 256."""
    centered = center(traces)
    sigma = welch_noise_estimate(centered)
    return centered / sigma[..., None]


@jax.jit
def standardize_block(block: Array) -> Array:
    """Center + noise-normalize every pixel of a (d1, d2, T) block
    (reference preprocessing_utils.py:84-94)."""
    return center_and_noise_normalize(block)


@jax.jit
def center_and_get_noise_estimate(movie: Array, mean: Array) -> Array:
    """Noise sigma image of a movie given its mean image (reference
    preprocessing_utils.py:43-56). movie (d1, d2, T), mean (d1, d2)."""
    return welch_noise_estimate(movie - mean[..., None])
