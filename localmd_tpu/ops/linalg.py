"""Linear-algebra primitives for PMD.

Design notes (vs the reference implementation):

- The reference calls ``jnp.linalg.svd`` on small matrices inside its hot
  per-block kernel (reference decomposition.py:64-66, 301, 315, 319). We
  instead use symmetric Gram / ``eigh`` formulations throughout — the same
  trick the reference itself uses for its *final* reformat (reference
  decomposition.py:1063-1137) — which are matmuls plus one small batched
  eigendecomposition.
- Everything here is batch-first: a leading ``...`` batch axis is supported by
  every routine so the per-block pipeline runs as one fused program over the
  whole patch grid instead of a host loop (reference decomposition.py:790-838).
- Matmuls request ``preferred_element_type=float32`` so products accumulate
  in f32 even if inputs are ever cast to a narrower type.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

DEFAULT_OVERSAMPLES = 10

# Test hook: when set, truncated_random_svd draws its Gaussian sketch from
# this callable (shape -> array) instead of the per-call PRNG key. Lets
# parity tests inject the SAME sketch into this implementation and the
# reference so the randomized factors become deterministic and comparable.
_SKETCH_OVERRIDE: Optional[Callable[[Tuple[int, ...]], Array]] = None


@contextlib.contextmanager
def sketch_override(fn: Callable[[Tuple[int, ...]], Array]):
    """Context manager replacing the rSVD Gaussian sketch with ``fn(shape)``.

    The override is read at trace time inside jitted callers, so jit caches
    are cleared on entry and exit to force retracing.
    """
    global _SKETCH_OVERRIDE
    _SKETCH_OVERRIDE = fn
    jax.clear_caches()
    try:
        yield
    finally:
        _SKETCH_OVERRIDE = None
        jax.clear_caches()


def _mm(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


def cholesky_qr2(y: Array) -> Array:
    """Orthonormalize the columns of ``y`` (..., d, k) via two rounds of
    CholeskyQR. Returns Q with the same column space as y.

    CholeskyQR2 is two Gram matmuls + two small triangular solves (no
    Householder sweep over the tall axis), and its two passes recover the
    orthogonality that a single CholeskyQR loses for ill-conditioned inputs (error ~ eps *
    cond(y)^2 -> eps after the second pass, fine for randomized sketches).
    A tiny ridge guards rank-deficient sketches (zero/duplicate columns).
    """

    def _one_pass(a):
        gram = _mm(jnp.swapaxes(a, -1, -2), a)
        k = gram.shape[-1]
        # trace >= lambda_max, so trace * 1e-6 safely dominates the f32 Gram
        # noise floor (~eps * lambda_max) that can push eigenvalues negative.
        trace = jnp.sum(jnp.diagonal(gram, axis1=-2, axis2=-1), axis=-1)
        ridge = (trace * 1e-6 + 1e-30)[..., None, None] * jnp.eye(k, dtype=a.dtype)
        chol = jnp.linalg.cholesky(gram + ridge)
        # q = a @ inv(chol).T  == solve chol^T x^T = a^T
        q = jax.lax.linalg.triangular_solve(
            chol, a, left_side=False, lower=True, transpose_a=True
        )
        return q

    return _one_pass(_one_pass(y))


def eigh_descending(sym: Array) -> Tuple[Array, Array]:
    """Eigendecomposition of a symmetric PSD matrix, eigenvalues descending.

    Accepts a batch: (..., k, k) -> ((..., k), (..., k, k)).
    """
    vals, vecs = jnp.linalg.eigh(sym)
    vals = jnp.flip(vals, axis=-1)
    vecs = jnp.flip(vecs, axis=-1)
    return vals, vecs


@partial(jax.jit, static_argnums=(1,))
def subspace_eigh(sym: Array, k_sketch: int) -> Tuple[Array, Array]:
    """Top-``k_sketch`` eigenpairs of a PSD (m, m) matrix with known rank
    bound ``rank(sym) <= k_sketch``, via randomized range capture.

    Full ``eigh`` cost grows superlinearly with m. The factorized-SVD
    reformat knows an a-priori rank bound for its Gram quadratic (the
    blockwise component budget), so one sketch pass captures the whole
    range exactly up to f32 rounding: ``Y = sym @ Om``, ``Q = qr(Y)``, then
    the (k, k) compression ``Q^T sym Q`` is decomposed and lifted back as
    ``V = Q W``. The m - k_sketch discarded directions lie in the numerical
    null space; callers already zero/drop eigenvalues at the f32 noise
    floor. Not measured against a plain ``eigh`` on the H100.

    The sketch is seeded deterministically from the shape alone, so results
    are reproducible run-to-run and independent of pipeline RNG state.

    Returns (vals (k_sketch,) descending, vecs (m, k_sketch)).
    """
    m = sym.shape[-1]
    key = jax.random.PRNGKey(m * 1000003 + k_sketch)
    om = jax.random.normal(key, (m, k_sketch), dtype=sym.dtype)
    # All three sketch products run at HIGHEST (full f32): a reduced-
    # precision pass leaves ~1e-2-relative noise whose random column space
    # pulls Q off the true range, drowning every eigendirection below
    # ~1e-3 * lambda_max (the pipeline's kept rank collapsed 233 -> 31).
    hi = jax.lax.Precision.HIGHEST
    # Householder QR, not choleskyQR2: the sketch Y is rank-deficient by
    # construction (rank(sym) < k_sketch), and the Cholesky ridge biases the
    # weak directions' norms at ~1e-3 — Householder stays orthonormal to f32
    # regardless of rank at sketch width.
    q, _ = jnp.linalg.qr(jnp.matmul(sym, om, precision=hi,
                                    preferred_element_type=jnp.float32))
    aq = jnp.matmul(sym, q, precision=hi, preferred_element_type=jnp.float32)
    small = jnp.matmul(jnp.swapaxes(q, -1, -2), aq, precision=hi,
                       preferred_element_type=jnp.float32)
    small = 0.5 * (small + jnp.swapaxes(small, -1, -2))
    vals, vecs = eigh_descending(small)
    return vals, jnp.matmul(q, vecs, precision=hi,
                            preferred_element_type=jnp.float32)


def svd_gram_left(data: Array) -> Tuple[Array, Array, Array]:
    """SVD of ``data`` (..., m, n) via the left Gram matrix ``data @ data.T``.

    Efficient when m <= n. Parity with reference ``fewer_rows_svd_routine``
    (reference decomposition.py:1063-1099): returns (U (...,m,m), s (...,m),
    Vt (...,m,n)); zero singular values yield zero rows of Vt.
    """
    gram = _mm(data, jnp.swapaxes(data, -1, -2))
    vals, vecs = eigh_descending(gram)
    s = jnp.sqrt(jnp.clip(vals, 0.0, None))
    divisor = jnp.where(s == 0, 1.0, s)
    vt = _mm(jnp.swapaxes(vecs, -1, -2), data) / divisor[..., :, None]
    return vecs, s, vt


def svd_gram_right(data: Array) -> Tuple[Array, Array, Array]:
    """SVD of ``data`` (..., m, n) via the right Gram matrix ``data.T @ data``.

    Efficient when n <= m. Parity with reference ``fewer_columns_svd_routine``
    (reference decomposition.py:1102-1137): returns (U (...,m,n), s (...,n),
    Vt (...,n,n)).
    """
    gram = _mm(jnp.swapaxes(data, -1, -2), data)
    vals, vecs = eigh_descending(gram)
    s = jnp.sqrt(jnp.clip(vals, 0.0, None))
    divisor = jnp.where(s == 0, 1.0, s)
    u = _mm(data, vecs / divisor[..., None, :])
    return u, s, jnp.swapaxes(vecs, -1, -2)


def svd_small(data: Array) -> Tuple[Array, Array, Array]:
    """SVD of a (..., m, n) matrix choosing the cheaper Gram side statically."""
    m, n = data.shape[-2], data.shape[-1]
    if m <= n:
        return svd_gram_left(data)
    return svd_gram_right(data)


@partial(jax.jit, static_argnums=(2, 3, 4))
def truncated_random_svd(
    matrix: Array,
    key: Array,
    rank: int,
    num_oversamples: int = DEFAULT_OVERSAMPLES,
    power_iters: int = 0,
) -> Tuple[Array, Array, Array]:
    """Randomized truncated SVD (Halko et al. sketch-project-solve).

    Parity target: reference ``truncated_random_svd`` (reference
    decomposition.py:37-73) — Gaussian sketch of ``rank + num_oversamples``
    columns, QR, project, small SVD, truncate. The small SVD is computed via
    the (rank+o)x(rank+o) Gram eigendecomposition instead of LAPACK SVD.

    Args:
        matrix: (..., d, t). Requires rank + num_oversamples <= min(d, t).
        key: jax PRNG key (one key; batch sketches are drawn jointly).
        rank: number of components to keep (static).
        power_iters: optional subspace (power) iterations — each adds two
            matmuls + one re-orthonormalization and sharpens the captured
            subspace when the spectrum decays slowly (Halko et al. alg 4.4;
            the reference has no equivalent).

    Returns:
        (u (..., d, rank), s (..., rank), vt (..., rank, t)).
    """
    t = matrix.shape[-1]
    k = rank + num_oversamples
    batch_shape = matrix.shape[:-2]
    if _SKETCH_OVERRIDE is not None:
        sketch = jnp.broadcast_to(
            _SKETCH_OVERRIDE((t, k)).astype(matrix.dtype), batch_shape + (t, k)
        )
    else:
        sketch = jax.random.normal(key, batch_shape + (t, k), dtype=matrix.dtype)
    return _rsvd_core(matrix, sketch, rank, power_iters)


def _rsvd_core(matrix: Array, sketch: Array, rank: int, power_iters: int):
    """The sketch-project-solve chain shared by the single and batched
    rSVD entry points (they differ only in how the sketch is drawn)."""
    projected = _mm(matrix, sketch)                      # (..., d, k)
    q = cholesky_qr2(projected)                          # (..., d, k)
    for _ in range(power_iters):
        z = _mm(jnp.swapaxes(matrix, -1, -2), q)         # (..., t, k)
        q = cholesky_qr2(_mm(matrix, z))
    b = _mm(jnp.swapaxes(q, -1, -2), matrix)             # (..., k, t)
    u_b, s, vt = svd_gram_left(b)                        # k x k gram
    u = _mm(q, u_b)
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def batched_truncated_random_svd(
    matrices: Array,
    keys: Array,
    rank: int,
    num_oversamples: int = DEFAULT_OVERSAMPLES,
    power_iters: int = 0,
) -> Tuple[Array, Array, Array]:
    """Randomized truncated SVD over a leading batch axis with per-item keys.

    ``matrices``: (n, d, t); ``keys``: (n, 2) — each batch item gets an
    independent sketch so results match running ``truncated_random_svd``
    per item (the batched analogue of the reference's per-block host loop).

    Natively batched (not vmapped): the solve chain (``_rsvd_core``, shared
    with the single-matrix entry point) then sees explicit (n, k, k)
    batches — what any future batched-solver swap-in needs, and no slower
    today. Only the sketch draw is vmapped (per-item keys).
    """
    n, d, t = matrices.shape
    k = rank + num_oversamples
    if _SKETCH_OVERRIDE is not None:
        sketch = jnp.broadcast_to(
            _SKETCH_OVERRIDE((t, k)).astype(matrices.dtype), (n, t, k)
        )
    else:
        sketch = jax.vmap(
            lambda kk: jax.random.normal(kk, (t, k), dtype=matrices.dtype)
        )(keys)
    return _rsvd_core(matrices, sketch, rank, power_iters)


def projected_svd(projection: Array, data: Array) -> Tuple[Array, Array, Array]:
    """SVD of ``data`` with ``projection`` applied to the left factor.

    Given a factorization ``U @ P @ V`` where ``U @ P`` is orthonormal,
    ``R, s, Vt = projected_svd(P, V)`` yields the SVD ``(U @ R) s Vt``.
    Parity: reference ``projected_svd`` (reference decomposition.py:1013-1060),
    including the short/tall Gram-side selection.
    """
    m, n = data.shape[-2], data.shape[-1]
    if m <= n:
        left, s, vt = svd_gram_left(data)
    else:
        left, s, vt = svd_gram_right(data)
    return _mm(projection, left), s, vt
