"""Drop-in namespace mirroring ``localmd.pmd_loader``.

Reference symbol surface (reference pmd_loader.py) over the
loader in :mod:`localmd_tpu.loader`. ``FrameDataloader`` is a lightweight
map-style adapter with the reference's merged-tail chunk semantics
(reference pmd_loader.py:71-108) — no torch dependency.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from localmd_tpu.loader import PMDLoader, standardize_and_filter, _chunk_ranges
from localmd_tpu.ops.linalg import truncated_random_svd as _trsvd
from localmd_tpu.utils import display, make_key
from localmd_tpu.utils.keys import make_jax_random_key
from localmd_tpu.dataset import as_dataset


def truncated_random_svd(input_matrix, key, rank: int, num_oversamples: int = 10):
    """Reference pmd_loader variant (pmd_loader.py:46-68): static int rank,
    singular values FOLDED into V, returns (U, V)."""
    u, s, vt = _trsvd(input_matrix, key, int(rank), num_oversamples=num_oversamples)
    return u, s[:, None] * vt


class FrameDataloader:
    """Map-style dataset of frame chunks (reference pmd_loader.py:71-108):
    ``len`` = number of chunks with the final partial chunk merged into the
    previous one; items are (d1, d2, t_chunk) host arrays."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = as_dataset(dataset)
        self.batch_size = int(batch_size)
        self._ranges = _chunk_ranges(
            self.dataset.shape[0], self.batch_size, merge_tail=True
        )

    def __len__(self) -> int:
        return len(self._ranges)

    def __getitem__(self, index: int) -> np.ndarray:
        # IndexError (not ValueError) so Python's legacy sequence-iteration
        # protocol terminates `for chunk in loader`; negative indices follow
        # torch map-style dataset semantics.
        n = len(self._ranges)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(f"chunk index {index} out of range")
        a, b = self._ranges[index]
        return np.asarray(self.dataset[slice(a, b)]).transpose(1, 2, 0)


def v_projection_inner_loop(dense_projector, sparse_projector, data):
    """Reference pmd_loader.py:405-414: ``P @ (U^T @ X)`` — the sparse
    projector applies first so the dense mix runs on the small rank axis.
    Accepts dense or BCOO projectors (anything supporting ``@``)."""
    return dense_projector @ (sparse_projector @ data)


@partial(jax.jit, static_argnums=(0,))
def v_projection_routine(
    order, dense_projection_term, sparse_projection_term, data, mean_img_r, std_img_r
):
    """Reference pmd_loader.py:392-401: flatten a (d1, d2, t) chunk in
    ``order``, standardize, and regress onto the spatial basis.

    The pipeline itself uses the folded one-matmul variant
    (:func:`localmd_tpu.loader._v_projection_kernel`) or the packed cell
    kernel (:func:`localmd_tpu.blocksparse.coset_vproj_chunk`); this shim
    keeps reference call sites working.
    """
    data = jnp.reshape(data, (-1, data.shape[2]), order=order)
    centered = (data - mean_img_r) / std_img_r
    return v_projection_inner_loop(
        dense_projection_term, sparse_projection_term, centered
    )


__all__ = [
    "PMDLoader",
    "FrameDataloader",
    "standardize_and_filter",
    "truncated_random_svd",
    "v_projection_routine",
    "v_projection_inner_loop",
    "display",
    "make_jax_random_key",
    "make_key",
]
