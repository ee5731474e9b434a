"""Spatial average-pool downsampling.

Parity with reference ``downsample_average_pooling``
(reference decomposition.py:192-232): n x n average pooling over the two
leading FOV dims of a (..., d1, d2, T) stack with SAME padding and
count-normalization of partial edge windows. Batched over leading dims.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array


@partial(jax.jit, static_argnums=(1,))
def downsample_average_pooling(array: Array, n: int) -> Array:
    """Average-pool (..., d1, d2, T) by n x n spatial windows (SAME padding)."""
    if n == 1:
        return array
    ndim = array.ndim
    d1, d2, t = array.shape[-3], array.shape[-2], array.shape[-1]
    if d1 % n == 0 and d2 % n == 0:
        # Evenly-divisible FOV (the common case: 32x32 blocks, n=2): SAME
        # padding degenerates to full windows with count n*n everywhere, so a
        # reshape+mean is exact and avoids reduce_window.
        lead = array.shape[:-3]
        pooled = array.reshape(lead + (d1 // n, n, d2 // n, n, t))
        return jnp.mean(pooled, axis=(-4, -2))
    window = (1,) * (ndim - 3) + (n, n, 1)
    summed = jax.lax.reduce_window(
        array, 0.0, jax.lax.add, window, window, "SAME"
    )
    ones = jnp.ones(array.shape[-3:-1] + (1,), dtype=array.dtype)
    counts = jax.lax.reduce_window(
        ones, 0.0, jax.lax.add, (n, n, 1), (n, n, 1), "SAME"
    )
    return summed / counts
