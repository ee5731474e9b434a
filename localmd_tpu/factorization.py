"""Factorized SVD reformat: U·V -> [U R] s Vt without densifying U.

Parity targets: reference ``compute_lowrank_factorized_svd``
(decomposition.py:936-1010) and ``projected_svd`` (decomposition.py:1013-1060).

Design: the reference materializes the sparse Gram matrix ``U.T U`` on
the host with scipy (decomposition.py:974). Our blocked-sparse ``U`` never
materializes a Gram — the (m, m) quadratic form ``right.T (U.T U) right`` is
computed from gather + batched panel matmuls, column-chunked to bound HBM.
Zero-padded slot columns of U contribute exact-zero eigenvalues which are
dropped by the same ``eig_vals > 0`` cut the reference applies
(decomposition.py:988-990).
"""

from __future__ import annotations

from typing import Tuple, Union

import jax.numpy as jnp
import numpy as np
import scipy.sparse
from jax import Array

from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.ops.linalg import eigh_descending, projected_svd, subspace_eigh

DEFAULT_COL_CHUNK = 1024


def _mm(a, b):
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


class _ScipySparseAdapter:
    """Minimal product interface over a scipy sparse U (host compute), so the
    public API also accepts reference-style scipy matrices."""

    def __init__(self, u):
        self._u = u.tocsr()
        self.shape = u.shape

    def gram_matmul(self, x: Array, col_chunk=None) -> Array:
        host = self._u.T.dot(self._u.dot(np.asarray(x)))
        return jnp.asarray(host)

    def gram_quadratic(self, right: Array, col_chunk=None) -> Array:
        g = _mm(jnp.asarray(right).T, self.gram_matmul(right))
        return 0.5 * (g + g.T)


def _as_product_operator(u):
    if isinstance(u, BlockSparseMatrix):
        return u
    if scipy.sparse.issparse(u):
        return _ScipySparseAdapter(u)
    raise TypeError(f"Unsupported spatial matrix type: {type(u)}")


def _gram_quadratic_mesh(
    u: BlockSparseMatrix, right: Array, mesh, col_chunk: int = DEFAULT_COL_CHUNK
) -> Array:
    """right^T (U^T U) right with the block panels sharded over ``mesh``
    (one psum at the pyramid-overlap seams; see parallel.sharded). Pads the
    block axis — and the corresponding rows of ``right`` — to a mesh
    multiple with zeros (zero panels contribute nothing)."""
    from localmd_tpu.parallel.sharded import sharded_gram_quadratic

    n_dev = mesh.devices.size
    n = u.n_blocks
    n_pad = ((n + n_dev - 1) // n_dev) * n_dev
    panels, rows = u.panels, u.rows
    nb_cols = u.n_block_cols
    right = jnp.asarray(right)
    if n_pad != n:
        pad = n_pad - n
        panels = jnp.concatenate(
            [panels, jnp.zeros((pad,) + panels.shape[1:], panels.dtype)], axis=0
        )
        rows = jnp.concatenate(
            [rows, jnp.zeros((pad, rows.shape[1]), rows.dtype)], axis=0
        )
        right = jnp.concatenate(
            [
                right[:nb_cols],
                jnp.zeros((pad * u.slots, right.shape[1]), right.dtype),
                right[nb_cols:],
            ],
            axis=0,
        )
    return sharded_gram_quadratic(
        mesh, panels, rows, u.dense_basis, right, u.n_pixels,
        col_chunk=col_chunk,
    )


def eigh_plan(m: int, k: int) -> Tuple[str, int]:
    """Which eigensolver ``compute_lowrank_factorized_svd`` uses for an
    (m, m) Gram with host-known rank bound ``k``: ("subspace", k_sketch) or
    ("full", k_sketch).

    rank(quad) <= rank(U) <= k, so when that bound sits well below m a
    randomized range capture replaces the full (m, m) eigh exactly (up to
    f32), avoiding a full eigh whose cost grows superlinearly with m (not
    measured on the H100 against a plain eigh). The +32 margin keeps the f32
    range capture comfortably overcomplete. This selection is a separate
    function because the pipeline's background stage warmer
    (aot.StageWarmer) must compile the SAME program this module will
    dispatch — keep any tuning here, not inline.
    """
    k_sketch = min(m, k + 32)
    if 4 * k_sketch <= 3 * m and m >= 512:
        return "subspace", k_sketch
    return "full", k_sketch


def compute_lowrank_factorized_svd(
    u: Union[BlockSparseMatrix, "scipy.sparse.spmatrix"],
    v: Array,
    only_left: bool = False,
    col_chunk: int = DEFAULT_COL_CHUNK,
    mesh=None,
    expected_rank: int = None,
):
    """SVD of the low-rank product ``u @ v``.

    Args:
        u: (d, R) sparse spatial factor (blocked-sparse or scipy).
        v: (R, T) dense temporal factor (zero rows at padded slots are fine).
        only_left: if True return only the spatial mixing matrix P
            ((R, r'), U @ P orthonormal).
        mesh: optional 1-D jax Mesh — the Gram quadratic form is computed
            with block panels sharded and one psum at the overlap seams.
        expected_rank: host-known rank of U (e.g. kept components + background
            from the pipeline's ``counts``). When given, the positive-eigenvalue
            cut keeps the top ``expected_rank`` directions with a DEVICE-side
            mask — no blocking device->host pull sits between the eigh and the
            downstream streaming pass (each sync idles the device while the
            host waits). Rank-deficient directions inside the top-k are
            zeroed (not dropped) and fall out of the final SVD as zero
            singular values, matching the reference's ``eig_vals > 0`` cut.

    Returns:
        P if ``only_left`` else (P', s, Vt) such that (U P') s Vt = U V.
    """
    op = _as_product_operator(u)
    r_cols = op.shape[1]
    v = jnp.asarray(v)
    t = v.shape[1]

    # Reference branch (decomposition.py:976-979): work in V's row space when
    # U has more columns than V has frames, else in the full column space.
    if r_cols > t:
        right = v
    else:
        right = jnp.eye(r_cols, dtype=v.dtype)

    if mesh is not None and isinstance(op, BlockSparseMatrix):
        quad = _gram_quadratic_mesh(op, right, mesh, col_chunk=col_chunk)  # (m, m)
    else:
        quad = op.gram_quadratic(right, col_chunk=col_chunk)   # (m, m)
    m = quad.shape[0]

    if expected_rank is not None:
        k = min(int(expected_rank), m)
        solver, k_sketch = eigh_plan(m, k)
        if solver == "subspace":
            eig_vals, eig_vecs = subspace_eigh(quad, k_sketch)
        else:
            eig_vals, eig_vecs = eigh_descending(quad)
        vals_k = eig_vals[:k]
        # relative cut at f32-Gram precision, computed on device: zero-padded
        # slot columns give an exact null space whose eigenvalues surface as
        # +/- float noise; dividing by their sqrt would amplify garbage.
        tol = jnp.maximum(eig_vals[0], 0.0) * 1e-6
        inv_sing = jnp.where(vals_k > tol, 1.0 / jnp.sqrt(jnp.maximum(vals_k, 1e-30)), 0.0)
        p = _mm(right, eig_vecs[:, :k] * inv_sing[None, :])     # (R, k)
        if only_left:
            return p
        new_temporal = _mm(p.T, op.gram_matmul(v, col_chunk=col_chunk))
        return projected_svd(p, new_temporal)

    eig_vals, eig_vecs = eigh_descending(quad)
    eig_vals_np = np.asarray(eig_vals)
    # The reference keeps eig_vals > 0 (decomposition.py:988); with our
    # zero-padded slot columns the Gram has an exact null space whose
    # eigenvalues surface as +/- float noise, so an absolute-zero cut would
    # keep garbage directions (then amplified by 1/sigma). Use a relative
    # cut at f32-Gram precision instead.
    tol = max(float(eig_vals_np[0]), 0.0) * 1e-6
    good = eig_vals_np > tol
    idx = np.nonzero(good)[0]
    eig_vecs = jnp.take(eig_vecs, jnp.asarray(idx), axis=1)
    sing = jnp.sqrt(jnp.asarray(eig_vals_np[good]))

    p = _mm(right, eig_vecs) / sing[None, :]                # (R, r')

    if only_left:
        return p

    new_temporal = _mm(p.T, op.gram_matmul(v, col_chunk=col_chunk))  # (r', T)
    return projected_svd(p, new_temporal)


def final_svd_reformat(p: Array, v: Array, rel_tol: float = 1e-3):
    """(R, s, Vt, keep) from the mixing matrix and regressed temporal matrix.

    The reference drops only exact-zero singular values
    (decomposition.py:896-904); in f32 the Gram-trick SVD produces garbage
    directions for any s below ~sqrt(eps) * s_max, so by default we also
    prune those (default rel_tol=1e-3, above sqrt(eps_f32)*s_max ~ the Gram
    noise floor; such components carry < 1e-6 of the movie's variance).
    Pass rel_tol=0 for strict reference parity.

    ``R``/``Vt`` are returned at FULL width with pruned slots zeroed in the
    host ``s`` array; ``keep`` is the boolean column mask (see the masking
    note below — PMDArray compacts lazily on host via ``k2_keep``).
    """
    r, s, vt = projected_svd(jnp.asarray(p), jnp.asarray(v))
    s_host = np.asarray(s)  # (K2,) — small pull
    cutoff = rel_tol * s_host[0] if (len(s_host) and rel_tol > 0) else 0.0
    good = s_host > cutoff if cutoff > 0 else s_host != 0
    # Pruning is a zero-MASK, not a device compaction: r and vt keep the
    # FULL K2 width with the pruned singular values zeroed in s, so the
    # shapes of every downstream device program are rank-INDEPENDENT (the
    # old jnp.take compactions compiled one program per final rank — an
    # unwarmable fresh compile per process).
    # All device consumers multiply r * s @ vt, where the zeros annihilate
    # the pruned columns exactly; host-facing factors compact lazily via
    # the returned mask (PMDArray k2_keep).
    # r and vt stay on device (PMDArray pulls them lazily only when host
    # slicing / serialization is requested).
    if not bool(good.all()):
        s_host = np.where(good, s_host, 0.0).astype(s_host.dtype)
    return r, s_host, vt, good


def aggregate_local_and_global_decomposition(
    u, v, spatial_basis, temporal_basis
):
    """Append the global background basis to a local factorization.

    scipy-level parity helper (reference decomposition.py:912-933): stacks
    the background spatial basis as extra columns of U and its temporal
    basis as extra rows of V. The pipeline does this structurally via
    BlockSparseMatrix.dense_basis; this function serves scipy-based callers.
    """
    spatial_bg_sparse = scipy.sparse.coo_matrix(np.asarray(spatial_basis))
    u_net = scipy.sparse.hstack([u, spatial_bg_sparse])
    v_net = np.concatenate([np.asarray(v), np.asarray(temporal_basis)], axis=0)
    return u_net, v_net
