"""PMDArray — lazy array view over the compressed movie ``[U R] s Vt``.

Parity with the reference ``PMDArray`` (reference pmdarray.py:7-171):
same constructor contract, properties, slicing semantics (key order
``[frames, dim1, dim2]``), un-normalization (x std + mean), frames-first
transpose, ``.squeeze()``, float32 output. The reference's latent
``len(key)==2`` bug — calling ``spatial_crop`` with two positional args
(reference pmdarray.py:146-148) — is fixed here.

Additions:

- Factors may live ON DEVICE (as produced by the pipeline). All host-side
  materialization — scipy CSR export, the compacted mixing matrix, the
  precomputed (R s) V product the reference builds eagerly in its ctor
  (reference pmdarray.py:50-52) — is LAZY: a user who only reconstructs
  frames on device never pays the device->host pulls.
- ``reconstruct_frames`` produces full-FOV frames on device with the
  blocked-sparse matmul (overlap-add + matmul) (the reference reconstructs on host CPU via
  scipy CSR, pmdarray.py:159).
- ``to_npz`` / ``from_npz`` round-trip the reference .npz convention.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse

from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.ops.tiling import unflatten_fov


# Per-chunk canvas budget for device-side slicing: bounds the (h, w, f)
# ROI reconstruction buffer so pmd[:, :, :] of an arbitrarily long movie
# streams through HBM in bounded pieces instead of materializing
# d1*d2*T*4 bytes at once. Device-scaled (HBM/16, 1 GiB floor — the same
# utils.device.transient_budget_bytes every other transient budget uses):
# a fixed 256 MB would chunk ~24x more than needed on a 95 GB v5p, each
# chunk a dispatch. Test/debug override: a number here pins the budget
# (None = device-scaled).
_SLICE_CANVAS_BUDGET_BYTES = None


def _slice_canvas_budget() -> int:
    if _SLICE_CANVAS_BUDGET_BYTES is not None:
        return _SLICE_CANVAS_BUDGET_BYTES
    from localmd_tpu.utils import transient_budget_bytes

    return transient_budget_bytes()


@partial(jax.jit, static_argnames=("b1", "b2", "h", "w"))
def _roi_reconstruct(
    panels_sub, t_sub, starts_rel, bg_rows, bg_t, *, b1, b2, h, w
):
    """Standardized reconstruction of an (h, w) ROI from the blocks that
    intersect it: batched panel matmul -> scatter-add placement (indices
    outside the ROI are dropped), plus the dense background term.

    panels_sub: (k, p, S) intersecting block panels (p = b1*b2, F-order rows)
    t_sub:      (k, S, f) their temporal slices
    starts_rel: (k, 2) block origins RELATIVE to the ROI origin (may be
                negative / extend past the ROI — mode="drop" crops them)
    bg_rows:    (h*w, K) background basis rows for the ROI (K may be 0)
    bg_t:       (K, f) background temporal block
    """
    # HIGHEST: __getitem__ parity with the host CSR path it replaces (scipy
    # products are full f32; the default precision may be bf16/TF32-class)
    contrib = jnp.matmul(
        panels_sub, t_sub, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    f = contrib.shape[-1]
    # F-order panel row r = i + j*b1 -> image axes (i, j)
    img = contrib.reshape(-1, b2, b1, f).transpose(0, 2, 1, 3)  # (k,b1,b2,f)
    rr = starts_rel[:, 0, None] + jnp.arange(b1)[None, :]       # (k, b1)
    cc = starts_rel[:, 1, None] + jnp.arange(b2)[None, :]       # (k, b2)
    # mode="drop" only drops indices >= size; NEGATIVE indices still wrap
    # (verified on jax 0.9), so rows/cols before the ROI origin must be
    # remapped to an out-of-bounds sentinel to be dropped too
    rr = jnp.where(rr < 0, h, rr)
    cc = jnp.where(cc < 0, w, cc)
    canvas = jnp.zeros((h, w, f), jnp.float32)
    canvas = canvas.at[rr[:, :, None], cc[:, None, :]].add(img, mode="drop")
    bg = jnp.matmul(
        bg_rows, bg_t, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return canvas + bg.reshape(h, w, f)


class PMDArray:
    def __init__(
        self,
        u: Union[scipy.sparse.spmatrix, BlockSparseMatrix],
        r,
        s,
        v,
        data_shape: Tuple[int, int, int],
        data_order: str,
        mean_img: np.ndarray,
        std_img: np.ndarray,
        counts: Optional[np.ndarray] = None,
        k2_keep: Optional[np.ndarray] = None,
    ):
        """
        Args:
            u: (d, K1) sparse spatial basis — scipy sparse (reference-style)
                or a BlockSparseMatrix with zero-padded slots (the pipeline).
                In the latter case ``counts`` gives kept components per block
                and U is compacted lazily for host/CSR operations.
            r: (K1, K2) mixing matrix (numpy or jax); U @ R orthonormal cols.
            s: (K2,) singular values (diagonal).
            v: (K2, T) orthonormal temporal basis (numpy or jax).
            data_shape: (n_frames, d1, d2).
            data_order: "F" or "C" pixel flattening convention.
            mean_img / std_img: (d1, d2) normalization images.
            k2_keep: optional (K2,) boolean mask of KEPT singular-value
                slots. The pipeline prunes by zero-MASKING s instead of
                compacting r/vt on device (the compaction program's shape
                would depend on the final rank — an unwarmable fresh
                compile per process); device
                reconstruction multiplies r * s @ vt, where the zeros
                annihilate pruned columns exactly, and the host-facing
                factors (``.r``/``.s``/``.v``, serialization) compact
                lazily through this mask.
        """
        self.order = data_order
        self.num_frames, self.fov_dim1, self.fov_dim2 = data_shape
        self._blocksparse: Optional[BlockSparseMatrix] = None
        self._counts = counts
        if k2_keep is not None:
            k2_keep = np.asarray(k2_keep, dtype=bool)
            if bool(k2_keep.all()):
                k2_keep = None  # nothing pruned: zero-overhead path
        self._k2_keep = k2_keep

        if isinstance(u, BlockSparseMatrix):
            if counts is None:
                raise ValueError("counts required with a BlockSparseMatrix U")
            self._blocksparse = u
            self._u_csr = None
            self._col_map = None
            self._r_padded = r          # (R_padded, K2), device or host
            self._r_compact = None
        else:
            self._u_csr = u.tocsr()
            self._col_map = None
            self._r_padded = None
            rc = np.asarray(r)
            if self._k2_keep is not None:
                # scipy-u path compacts R eagerly (there is no device copy
                # to preserve), keeping .r/.s/.v widths consistent
                rc = rc[:, self._k2_keep]
            self._r_compact = rc

        # s / mean / std are kept as their (possibly device) sources and
        # materialized to host lazily: pulling them eagerly costs one blocking
        # device->host copy each at construction time, on the pipeline
        # critical path.
        self._s_src = s
        self._s_host: Optional[np.ndarray] = None
        self._v_src = v
        self._v_host: Optional[np.ndarray] = None
        self._combined_temporal_host: Optional[np.ndarray] = None
        self._combined_temporal_dev = None
        self._mean_src = mean_img
        self._mean_host: Optional[np.ndarray] = None
        self._var_src = std_img
        self._var_host: Optional[np.ndarray] = None
        self.row_indices = np.arange(self.fov_dim1 * self.fov_dim2).reshape(
            (self.fov_dim1, self.fov_dim2), order=self.order
        )

    # -- lazy materialization ---------------------------------------------------

    def _ensure_csr(self):
        if self._u_csr is None:
            if self._blocksparse is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            self._u_csr, self._col_map = self._blocksparse.to_csr(self._counts)
        return self._u_csr

    # -- properties (reference pmdarray.py:59-87) ----------------------------

    @property
    def u(self) -> scipy.sparse.csr_matrix:
        return self._ensure_csr()

    @property
    def r(self) -> np.ndarray:
        if self._r_compact is None:
            self._ensure_csr()
            if self._r_padded is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            rc = np.asarray(self._r_padded)[self._col_map, :]
            if self._k2_keep is not None:
                rc = rc[:, self._k2_keep]
            self._r_compact = rc
        return self._r_compact

    @property
    def s(self) -> np.ndarray:
        if self._s_host is None:
            if self._s_src is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            sh = np.asarray(self._s_src)
            if self._k2_keep is not None:
                sh = sh[self._k2_keep]
            self._s_host = sh
        return self._s_host

    @property
    def mean_img(self) -> np.ndarray:
        if self._mean_host is None:
            if self._mean_src is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            self._mean_host = np.asarray(self._mean_src)
        return self._mean_host

    @property
    def var_img(self) -> np.ndarray:
        if self._var_host is None:
            if self._var_src is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            self._var_host = np.asarray(self._var_src)
        return self._var_host

    @property
    def v(self) -> np.ndarray:
        if self._v_host is None:
            if self._v_src is None:
                raise RuntimeError(
                    "PMDArray was closed with materialize=False before its "
                    "host factors were materialized; no data remains"
                )
            vh = np.asarray(self._v_src)
            if self._k2_keep is not None:
                vh = vh[self._k2_keep]
            self._v_host = vh
        return self._v_host

    @property
    def dtype(self):
        return np.float32

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.num_frames, self.fov_dim1, self.fov_dim2)

    @property
    def ndim(self) -> int:
        return 3

    @property
    def rank(self) -> int:
        if self._k2_keep is not None:
            return int(self._k2_keep.sum())
        src = self._s_host if self._s_src is None else self._s_src
        if src is None:
            raise RuntimeError(
                "PMDArray was closed with materialize=False before its "
                "host factors were materialized; no data remains"
            )
        return int(src.shape[0])

    @property
    def _combined_temporal(self) -> np.ndarray:
        """(K1_compact, T) = (R * s) V, built lazily (reference builds this
        eagerly at pmdarray.py:50-52)."""
        if self._combined_temporal_host is None:
            self._combined_temporal_host = (self.r * self.s[None, :]).dot(self.v)
        return self._combined_temporal_host

    # -- device fast path ------------------------------------------------------

    def reconstruct_frames(self, frame_indices) -> jnp.ndarray:
        """Reconstruct full-FOV frames on device: (n_frames_req, d1, d2).

        Output is un-normalized (x std + mean). Falls back to the host CSR
        path if this array was built from a scipy matrix.
        """
        frame_indices = np.atleast_1d(np.asarray(frame_indices))
        if self._blocksparse is None:
            out = self._getitem_host((frame_indices, slice(None), slice(None)))
            return jnp.asarray(out.reshape((-1, self.fov_dim1, self.fov_dim2)))
        if self._combined_temporal_dev is None:
            self._combined_temporal_dev = jnp.matmul(
                jnp.asarray(self._r_padded) * jnp.asarray(self._s_src)[None, :],
                jnp.asarray(self._v_src),
                precision=jax.lax.Precision.HIGHEST,
            )
        # chunk the frame axis: bounds the (d1, d2, f) f32 canvas
        parts = []
        for s in range(0, len(frame_indices), 512):
            sub = jnp.asarray(frame_indices[s : s + 512])
            parts.append(
                self._reconstruct_standardized(self._combined_temporal_dev[:, sub])
            )
        movie = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
        movie = movie * jnp.asarray(self._var_src)[..., None] + jnp.asarray(
            self._mean_src
        )[..., None]
        return jnp.moveaxis(movie, -1, 0)

    def _reconstruct_standardized(self, temporal) -> jnp.ndarray:
        """U @ temporal as a (d1, d2, f) image: the blocked-sparse matmul
        (overlap-add through the coset placement when the grid allows it,
        an XLA scatter-add otherwise), then the pixel-order unflatten."""
        flat = self._blocksparse.matmul(temporal)                 # (d, f)
        return unflatten_fov(flat, self.fov_dim1, self.fov_dim2, self.order)

    # -- device slicing (north-star path) ---------------------------------------

    def _device_temporal(self, frame_idx) -> jnp.ndarray:
        """(R_padded, f) = (R * s) V[:, frame_idx], computed on the fly —
        unlike ``reconstruct_frames``'s full-T cache, slicing never
        materializes the (R_padded, T) product (multi-GB for long movies)."""
        rp = jnp.asarray(self._r_padded)
        s = jnp.asarray(self._s_src)
        v = jnp.asarray(self._v_src)
        return jnp.matmul(
            rp * s[None, :],
            v[:, jnp.asarray(frame_idx)],
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def _normalize_key3(self, key):
        """Split a __getitem__ key into (frames, k1, k2) with the reference's
        validation (key order [frames, dim1, dim2], reference pmdarray.py:132)."""
        if len(key) > 3:
            raise ValueError("Too many indices in __getitem__")
        frames = key[0]
        k1 = key[1] if len(key) > 1 else slice(None)
        k2 = key[2] if len(key) > 2 else slice(None)
        if frames is None or k1 is None or k2 is None:
            raise ValueError("Cannot use None for indexing")
        return frames, k1, k2

    def _slice_pixel_extent(self, used_rows) -> int:
        """Pixels a device slicing chunk actually ALLOCATES for this
        selection: the ROI bounding-box area on the geometry path (the
        canvas is (h, w, f) however few pixels are selected), the full FOV
        on the no-geometry fallback (full blocked matmul)."""
        u = self._blocksparse
        if u.starts is None or u.block_shape is None:
            return self.fov_dim1 * self.fov_dim2
        d1, d2 = self.fov_dim1, self.fov_dim2
        if self.order == "F":
            r = used_rows % d1
            c = used_rows // d1
        else:
            r = used_rows // d2
            c = used_rows % d2
        return int(
            (int(r.max()) - int(r.min()) + 1)
            * (int(c.max()) - int(c.min()) + 1)
        )

    def _slice_device_chunk(self, used_rows, frame_idx) -> jnp.ndarray:
        """Standardized (no mean/std) device reconstruction of the pixels in
        ``used_rows`` (host int array, any shape, global flat ids in
        ``self.order``) for ``frame_idx`` frames -> (*used_rows.shape, f)."""
        u = self._blocksparse
        temporal = self._device_temporal(frame_idx)           # (R_padded, f)
        nb = u.n_block_cols
        f = int(np.asarray(frame_idx).size)

        if u.starts is None or u.block_shape is None:
            # no geometry (hand-built U): full-FOV blocked matmul, then gather
            flat = u.matmul(temporal)                         # (n_pixels, f)
            out = flat[jnp.asarray(used_rows.reshape(-1))]
            return out.reshape(used_rows.shape + (f,))

        b1, b2 = u.block_shape
        if getattr(self, "_starts_host", None) is None:
            self._starts_host = np.asarray(u.starts)
        starts_host = self._starts_host
        d1, d2 = self.fov_dim1, self.fov_dim2
        if self.order == "F":
            r = used_rows % d1
            c = used_rows // d1
        else:
            r = used_rows // d2
            c = used_rows % d2
        r0, r1 = int(r.min()), int(r.max()) + 1
        c0, c1 = int(c.min()), int(c.max()) + 1
        h, w = r1 - r0, c1 - c0

        hit = np.nonzero(
            (starts_host[:, 0] < r1) & (starts_host[:, 0] + b1 > r0)
            & (starts_host[:, 1] < c1) & (starts_host[:, 1] + b2 > c0)
        )[0]
        hit_dev = jnp.asarray(hit)
        t_blocks = temporal[:nb].reshape(u.n_blocks, u.slots, f)
        ids = self.row_indices[r0:r1, c0:c1].reshape(-1)      # C-order, = canvas layout
        k_bg = int(u.dense_basis.shape[1])
        if k_bg:
            bg_rows = u.dense_basis[jnp.asarray(ids)]
            bg_t = temporal[nb:]
        else:
            bg_rows = jnp.zeros((h * w, 0), jnp.float32)
            bg_t = jnp.zeros((0, f), jnp.float32)
        canvas = _roi_reconstruct(
            jnp.take(u.panels, hit_dev, axis=0),
            jnp.take(t_blocks, hit_dev, axis=0),
            jnp.take(u.starts, hit_dev, axis=0) - jnp.array([r0, c0]),
            bg_rows, bg_t, b1=b1, b2=b2, h=h, w=w,
        )
        rel = (r - r0) * w + (c - c0)
        out = canvas.reshape(h * w, f)[jnp.asarray(rel.reshape(-1))]
        return out.reshape(used_rows.shape + (f,))

    def _getitem_device(self, key) -> np.ndarray:
        """Reference slicing semantics executed ON DEVICE: only the blocks
        intersecting the requested ROI are touched (batched panel matmul +
        placement — never the CSR export, BASELINE north star). Index
        normalization (fancy pairing, slices, negatives, bounds errors) is
        done with numpy on the tiny ``row_indices`` grid, so the semantics
        are numpy's own, identical to the host path."""
        frames, k1, k2 = self._normalize_key3(key)
        k1 = self._parse_int_to_list(k1)
        k2 = self._parse_int_to_list(k2)
        used_rows = np.asarray(self.row_indices[k1, k2])
        mean_used = self.mean_img[k1, k2]
        var_used = self.var_img[k1, k2]
        frame_idx = np.atleast_1d(
            np.arange(self.num_frames)[self._parse_int_to_list(frames)]
        )
        n_f = int(frame_idx.size)
        out_shape = (n_f,) + used_rows.shape
        if used_rows.size == 0 or n_f == 0:
            return np.zeros(out_shape, dtype=np.float32)

        # chunk the frame axis: bound the ROI canvas (h*w*f floats) so full-
        # movie slices of long recordings never blow HBM. The budget divides
        # by what the chunk ALLOCATES — the bounding-box area (or the full
        # FOV on the no-geometry fallback), NOT the selected-pixel count:
        # a strided/scattered selection like pmd[:, ::8, ::8] still builds
        # the full-extent canvas.
        roi_pixels = max(1, self._slice_pixel_extent(used_rows))
        per_chunk = max(1, _slice_canvas_budget() // (4 * roi_pixels))
        var_dev = jnp.asarray(np.asarray(var_used, dtype=np.float32))[..., None]
        mean_dev = jnp.asarray(np.asarray(mean_used, dtype=np.float32))[..., None]
        parts = []
        for s in range(0, n_f, per_chunk):
            std = self._slice_device_chunk(used_rows, frame_idx[s : s + per_chunk])
            parts.append(np.asarray(jnp.moveaxis(std * var_dev + mean_dev, -1, 0)))
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def slice_device(self, *key) -> jnp.ndarray:
        """Device-resident slicing: like ``pmd[frames, rows, cols]`` but
        returns a jax Array (frames-first, un-squeezed) and requires the
        device factors to still be live (before ``close()``)."""
        if self._blocksparse is None:
            raise RuntimeError(
                "slice_device needs the device factors; this PMDArray was "
                "built from host factors or already closed — use __getitem__"
            )
        frames, k1, k2 = self._normalize_key3(key)
        k1 = self._parse_int_to_list(k1)
        k2 = self._parse_int_to_list(k2)
        used_rows = np.asarray(self.row_indices[k1, k2])
        var_dev = jnp.asarray(
            np.asarray(self.var_img[k1, k2], dtype=np.float32)
        )[..., None]
        mean_dev = jnp.asarray(
            np.asarray(self.mean_img[k1, k2], dtype=np.float32)
        )[..., None]
        frame_idx = np.atleast_1d(
            np.arange(self.num_frames)[self._parse_int_to_list(frames)]
        )
        if used_rows.size == 0 or frame_idx.size == 0:
            return jnp.zeros(
                (int(frame_idx.size),) + used_rows.shape, jnp.float32
            )
        std = self._slice_device_chunk(used_rows, frame_idx)
        return jnp.moveaxis(std * var_dev + mean_dev, -1, 0)

    # -- host slicing (reference semantics) ------------------------------------

    def _parse_int_to_list(self, elt):
        if isinstance(elt, (int, np.integer)):
            return [int(elt)]
        return elt

    def spatial_crop(self, key):
        """(reference pmdarray.py:95-117)."""
        if key[0] is None or key[1] is None:
            raise ValueError("Cannot pass None for indexing")
        key = (self._parse_int_to_list(key[0]), self._parse_int_to_list(key[1]))
        used_rows = self.row_indices[key[0], key[1]]
        mean_used = self.mean_img[key[0], key[1]]
        var_used = self.var_img[key[0], key[1]]
        u_used = self._ensure_csr()[used_rows.reshape((-1,), order=self.order)]
        return u_used, mean_used, var_used, used_rows.shape

    def temporal_crop(self, key) -> np.ndarray:
        if key is None:
            raise ValueError("Cannot use None for indexing")
        return self._combined_temporal[:, self._parse_int_to_list(key)]

    def _getitem_host(self, key) -> np.ndarray:
        if len(key) == 1:
            spatial, mean_used, var_used, implied_fov = self.spatial_crop(
                (slice(None), slice(None))
            )
            temporal = self.temporal_crop(key[0])
        elif len(key) == 2:
            spatial, mean_used, var_used, implied_fov = self.spatial_crop(
                (key[1], slice(None))
            )
            temporal = self.temporal_crop(key[0])
        elif len(key) == 3:
            spatial, mean_used, var_used, implied_fov = self.spatial_crop(
                (key[1], key[2])
            )
            temporal = self.temporal_crop(key[0])
        else:
            raise ValueError("Too many indices in __getitem__")

        output = spatial.dot(temporal)
        output = output.reshape(implied_fov + (-1,), order=self.order) * np.expand_dims(
            var_used, axis=var_used.ndim
        ) + np.expand_dims(mean_used, axis=mean_used.ndim)
        output = np.transpose(output, axes=(output.ndim - 1, *range(output.ndim - 1)))
        return output

    def __getitem__(self, key) -> np.ndarray:
        if key is None:
            raise ValueError("Cannot use None for indexing")
        if not isinstance(key, tuple):
            key = (key,)
        if self._blocksparse is not None:
            # device factors live: slice on-chip (no CSR materialization,
            # no multi-GB D2H pull — BASELINE north star). Host path only
            # for scipy/npz-built or already-closed arrays.
            return self._getitem_device(key).squeeze().astype(self.dtype)
        return self._getitem_host(key).squeeze().astype(self.dtype)

    # -- resource management ----------------------------------------------------

    def close(self, materialize: bool = True) -> None:
        """Release device (HBM) buffers held by this array.

        The factorization's device arrays (block panels, mixing matrix, V,
        cached reconstruction products) can occupy several GB for large FOVs;
        a library user looping over movies in one process should ``close()``
        (or use the context manager) before starting the next decomposition.
        Host-side state (CSR export, numpy factors) survives if it was
        already materialized, so slicing keeps working after close — only
        the device fast path (``reconstruct_frames``) degrades to host CSR.

        With ``materialize=False`` device buffers are dropped WITHOUT first
        pulling the factors to host — no device->host transfer at all. The
        array
        is then unusable for further slicing unless the host factors were
        already materialized earlier.
        """
        if self._blocksparse is not None:
            if materialize:
                # materialize host factors first so __getitem__ keeps working
                self._ensure_csr()
                _ = self.r, self.v
            self._blocksparse = None
        elif materialize and self._v_host is None and self._v_src is not None:
            # scipy/npz-built arrays: V may still be the (possibly device)
            # source array; take the host copy so slicing keeps working
            _ = self.v
        if materialize:
            # per-factor guards keep close() idempotent after an earlier
            # close(materialize=False) — e.g. the context manager's __exit__
            if self._s_host is not None or self._s_src is not None:
                _ = self.s
            if self._mean_host is not None or self._mean_src is not None:
                _ = self.mean_img
            if self._var_host is not None or self._var_src is not None:
                _ = self.var_img
        self._combined_temporal_dev = None
        self._starts_host = None
        self._r_padded = None

        # drop the DEVICE references (keeping them would pin their HBM);
        # with materialize=True (or an earlier host access) the host copies
        # take over. Sources that are already host numpy arrays (npz/scipy-
        # built PMDArrays) pin no HBM and need no transfer, so they survive
        # even with materialize=False.
        def _survivor(src, host):
            if host is not None:
                return host
            return src if isinstance(src, np.ndarray) else None

        self._v_src = _survivor(self._v_src, self._v_host)
        self._s_src = _survivor(self._s_src, self._s_host)
        self._mean_src = _survivor(self._mean_src, self._mean_host)
        self._var_src = _survivor(self._var_src, self._var_host)

    def block_until_ready(self) -> "PMDArray":
        """Wait until every device factor has been computed (dispatch is
        asynchronous, so a wall-clock timing of the pipeline ends here)."""
        factors = [self._r_padded, self._s_src, self._v_src,
                   self._mean_src, self._var_src]
        if self._blocksparse is not None:
            factors += [self._blocksparse.panels, self._blocksparse.dense_basis]
        jax.block_until_ready([f for f in factors if isinstance(f, jax.Array)])
        return self

    def __enter__(self) -> "PMDArray":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- export -----------------------------------------------------------------

    def export_tiff(
        self,
        filename: str,
        frames=None,
        chunk_frames: int = 512,
        dtype="float32",
    ) -> None:
        """Write the denoised (reconstructed) movie as a multipage TIFF.

        Streams device reconstruction chunk by chunk into the file — the
        full movie is never materialized in host RAM, so arbitrarily long
        exports work. ``dtype`` may be an integer type (e.g. "uint16") for
        scanner-compatible output; values are clipped to its range.
        """
        frame_idx = np.atleast_1d(
            np.arange(self.num_frames) if frames is None else np.asarray(frames)
        )
        out_dt = np.dtype(dtype)

        def _gen():
            for s in range(0, len(frame_idx), chunk_frames):
                sub = frame_idx[s : s + chunk_frames]
                chunk = np.asarray(self.reconstruct_frames(sub))
                if out_dt.kind in ("u", "i"):
                    info = np.iinfo(out_dt)
                    chunk = np.clip(np.rint(chunk), info.min, info.max)
                yield from chunk.astype(out_dt)

        from localmd_tpu.io.tiff import write_tiff_stream

        write_tiff_stream(
            filename,
            _gen(),
            (len(frame_idx), self.fov_dim1, self.fov_dim2),
            out_dt,
        )

    # -- serialization ---------------------------------------------------------

    def to_npz(self, filename: str) -> None:
        from localmd_tpu.serialization import save_decomposition

        save_decomposition(filename, self)

    @classmethod
    def from_npz(cls, filename: str) -> "PMDArray":
        from localmd_tpu.serialization import load_decomposition

        return load_decomposition(filename)
