"""Lazy dataset protocol + concrete movie readers.

Mirrors the capability surface of the reference ``lazy_data_loader`` ABC and
``TiffArray`` (reference dataset.py:7-181), with a device-pipeline-friendly
contract: datasets yield ``(T, d1, d2)`` numpy frames on the host; all
device placement happens downstream in the loader.

Differences from the reference, by design:

- ``PMDDataset`` is the class name the reference README promises
  (reference README.md:68) but the code never defines; we define it and keep
  ``lazy_data_loader`` as an alias for drop-in compatibility.
- The contract stays duck-typed: any object with ``.shape`` and
  frame-list indexing works (the reference tests pass a bare ``np.ndarray``,
  reference test/test_pmd.py:54). ``as_dataset`` normalizes inputs.
- ``TiffArray`` uses our native reader (:mod:`localmd_tpu.io.tiff`) and
  caches the page index, instead of re-opening + re-parsing the file on
  every access like the reference (reference dataset.py:155-181).
- Extra sources useful in production: ``RawBinaryArray`` (memmap),
  ``NpyArray``, ``ZStackArray`` (multi-plane volumetric wrapper, see
  BASELINE.json config 5).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence, Tuple, Union

import numpy as np

from localmd_tpu.io.tiff import TiffReader

FrameIndexer = Union[int, list, np.ndarray, slice, range]


class PMDDataset(ABC):
    """Numpy-like lazy random access to a (T, d1, d2) movie.

    Implement ``dtype``, ``shape`` and ``_compute_at_indices`` to support a
    new file format (same two-member contract as reference dataset.py:116-128).
    """

    @property
    @abstractmethod
    def dtype(self) -> np.dtype:
        ...

    @property
    @abstractmethod
    def shape(self) -> Tuple[int, int, int]:
        """(n_frames, d1, d2)."""
        ...

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @abstractmethod
    def _compute_at_indices(self, indices: Union[list, int, slice]) -> np.ndarray:
        """Return frames at the requested temporal indices as (T, d1, d2)."""
        ...

    def _normalize_frame_indexer(self, frame_indexer: FrameIndexer):
        n = self.shape[0]
        if isinstance(frame_indexer, np.ndarray):
            frame_indexer = frame_indexer.tolist()
        if isinstance(frame_indexer, np.integer):
            frame_indexer = int(frame_indexer)
        if isinstance(frame_indexer, (slice, range)):
            start, stop, step = frame_indexer.start, frame_indexer.stop, frame_indexer.step
            if start is not None and start > n:
                raise IndexError(f"frame start {start} beyond n_frames {n}")
            if stop is not None and stop > n:
                raise IndexError(f"frame stop {stop} beyond n_frames {n}")
            return slice(start, stop, step if step is not None else 1)
        if isinstance(frame_indexer, (int, list)):
            return frame_indexer
        raise IndexError(f"Invalid frame indexer type: {type(frame_indexer)}")

    def __getitem__(self, item):
        if isinstance(item, tuple):
            if len(item) > len(self.shape):
                raise IndexError(
                    f"Too many indices ({len(item)}) for {len(self.shape)}-d dataset"
                )
            frame_indexer = item[0]
        else:
            frame_indexer = item

        frame_indexer = self._normalize_frame_indexer(frame_indexer)
        frames = self._compute_at_indices(frame_indexer)
        if frames.ndim < len(self.shape):
            frames = np.expand_dims(frames, axis=0)

        if isinstance(item, tuple):
            if len(item) == 2:
                frames = frames[:, item[1]]
            elif len(item) == 3:
                frames = frames[:, item[1], item[2]]
        return frames.squeeze()


# Backwards-compatible alias matching the reference class name
# (reference dataset.py:7).
lazy_data_loader = PMDDataset


class NumpyArray(PMDDataset):
    """Adapter wrapping an in-memory (T, d1, d2) ndarray."""

    def __init__(self, array: np.ndarray):
        array = np.asarray(array)
        if array.ndim != 3:
            raise ValueError("NumpyArray expects a (T, d1, d2) array")
        self._array = array

    @property
    def dtype(self) -> np.dtype:
        return self._array.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._array.shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._array[indices])


class TiffArray(PMDDataset):
    """Multipage TIFF movie (reference dataset.py:131-181 parity), backed by
    the native :class:`localmd_tpu.io.tiff.TiffReader` (mmap + one-time page
    index, rather than per-call header re-parse).

    When the native parser rejects a file (an exotic codec or layout outside
    its subset) and ``tifffile`` is importable, the array falls back to a
    tifffile backend with a warning — the reference reads anything tifffile
    reads (reference dataset.py:169-181), so breadth is preserved wherever
    that package is installed. Without tifffile the error names both."""

    def __init__(self, filename: str):
        self.filename = filename
        self._tifffile = None
        try:
            self._reader = TiffReader(filename)
        except ValueError as native_err:
            try:
                import tifffile
            except ImportError:
                raise ValueError(
                    f"{native_err} — and the 'tifffile' fallback is not "
                    "installed (pip install tifffile to read formats outside "
                    "the native reader's subset)"
                ) from native_err
            import warnings

            warnings.warn(
                f"native TIFF reader rejected {filename!r} ({native_err}); "
                "falling back to tifffile (slower random access)",
                stacklevel=2,
            )
            self._reader = None
            self._tifffile = tifffile
            with tifffile.TiffFile(filename) as tf:
                n = len(tf.pages)
                p0 = tf.pages[0]
                page_shape = tuple(p0.shape)
                if len(page_shape) != 2:
                    # RGB / multi-sample pages: PMD needs (T, d1, d2)
                    # grayscale; reshaping the last two dims would silently
                    # mangle channels
                    raise ValueError(
                        f"{filename}: pages have shape {page_shape}; only "
                        "single-sample (grayscale) movies are supported — "
                        "convert multi-channel data to grayscale first"
                    ) from native_err
                self._tf_shape = (n,) + page_shape
                self._tf_dtype = np.dtype(p0.dtype)

    def set_io_threads(self, n: int) -> None:
        """Map the pipeline's ``num_workers`` onto the native reader's thread
        count (the reference maps it onto torch DataLoader processes)."""
        if self._reader is None:
            return
        reader = getattr(self._reader, "_fast_reader", None)
        if reader is not None:
            reader.n_threads = max(1, int(n))
        self._reader._io_threads = max(1, int(n))

    @property
    def dtype(self) -> np.dtype:
        # Reference TiffArray presents data as float32 (reference dataset.py:143-148)
        return np.dtype(np.float32)

    @property
    def raw_dtype(self) -> np.dtype:
        return self._reader.dtype if self._reader is not None else self._tf_dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        if self._reader is None:
            return self._tf_shape
        return (len(self._reader),) + self._reader.frame_shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        if isinstance(indices, int):
            idx = [indices]
        elif isinstance(indices, slice):
            idx = list(range(indices.start or 0, indices.stop or self.shape[0], indices.step or 1))
        else:
            idx = list(indices)
        if self._reader is None:
            # tifffile backend (reference dataset.py:169-181 semantics)
            out = self._tifffile.imread(self.filename, key=idx)
            out = np.asarray(out, dtype=np.float32)
            return out.reshape((len(idx),) + self._tf_shape[1:])
        return self._reader.read_frames(idx).astype(np.float32)


class RawBinaryArray(PMDDataset):
    """Headerless binary movie via memmap: shape and dtype supplied by caller.

    This is the fastest path for production streaming (no parsing, the OS page
    cache does the prefetching) and the format our benchmark generator emits.
    """

    def __init__(self, filename: str, shape: Tuple[int, int, int], dtype="uint16", offset: int = 0):
        self.filename = filename
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self._mm = np.memmap(filename, dtype=self._dtype, mode="r", offset=offset, shape=self._shape)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._mm[indices])


class NpyArray(PMDDataset):
    """.npy movie file, memory-mapped."""

    def __init__(self, filename: str):
        self.filename = filename
        self._mm = np.load(filename, mmap_mode="r")
        if self._mm.ndim != 3:
            raise ValueError(".npy movie must be (T, d1, d2)")

    @property
    def dtype(self) -> np.dtype:
        return self._mm.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._mm.shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._mm[indices])


class ZStackArray:
    """Multi-plane volumetric movie: a list of per-plane (T, d1, d2) datasets.

    Each plane is an independent PMD problem (BASELINE.json config 5); the
    pipeline shards planes across the device mesh. This is a thin container,
    not a PMDDataset — per-plane datasets are fed to the decomposition.
    """

    def __init__(self, planes: Sequence):
        if not planes:
            raise ValueError("ZStackArray needs at least one plane")
        self.planes = [as_dataset(p) for p in planes]
        s0 = self.planes[0].shape
        for p in self.planes[1:]:
            if p.shape != s0:
                raise ValueError("All planes must share shape")

    @property
    def n_planes(self) -> int:
        return len(self.planes)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.n_planes,) + tuple(self.planes[0].shape)

    @classmethod
    def from_interleaved(cls, source, n_planes: int) -> "ZStackArray":
        """Deinterleave a plane-cycling acquisition into a z-stack.

        Volumetric microscopes commonly save one movie whose frames cycle
        through the z-planes (frame t belongs to plane ``t % n_planes``).
        Returns a stack of :class:`PlaneView` lazy views — no data is copied;
        each plane reads only its own frames from the source. When the total
        frame count is not divisible by ``n_planes`` (a truncated volume
        cycle at the end of acquisition), every plane is cut to the common
        ``T // n_planes`` length so the stack stays rectangular.
        """
        if n_planes < 1:
            raise ValueError(f"n_planes must be >= 1, got {n_planes}")
        src = as_dataset(source)  # once: path inputs parse/open a single reader
        t_total = src.shape[0]
        if t_total < n_planes:
            raise ValueError(
                f"movie has {t_total} frames, fewer than n_planes={n_planes}"
            )
        n_frames = t_total // n_planes
        if isinstance(src, DeviceMovie):
            # keep device residency: strided device slices, no D2H round trip
            return cls(
                [
                    DeviceMovie(src._array[z::n_planes][:n_frames])
                    for z in range(n_planes)
                ]
            )
        return cls(
            [PlaneView(src, z, n_planes, n_frames) for z in range(n_planes)]
        )


class PlaneView(PMDDataset):
    """Lazy view of plane ``z`` of an interleaved (T*Z, d1, d2) source.

    Plane-frame ``t`` maps to source frame ``z + t * n_planes``. The source
    can be any PMDDataset / ndarray-like; reads stay lazy, so a from-disk
    TIFF z-stack streams per plane without materializing the whole movie.
    """

    def __init__(self, source, z: int, n_planes: int, n_frames: int = None):
        self._source = as_dataset(source)
        if not 0 <= z < n_planes:
            raise ValueError(f"plane {z} outside 0..{n_planes - 1}")
        self._z = int(z)
        self._n_planes = int(n_planes)
        t_total = self._source.shape[0]
        avail = (t_total - self._z + n_planes - 1) // n_planes
        self._n_frames = int(n_frames) if n_frames is not None else avail
        if self._n_frames > avail:
            raise ValueError(
                f"plane {z} has only {avail} frames, asked for {self._n_frames}"
            )
        # native storage dtype passthrough (the loader's HBM movie cache
        # retains frames in raw dtype when the source exposes one)
        raw = getattr(self._source, "raw_dtype", None)
        if raw is not None:
            self.raw_dtype = raw

    @property
    def dtype(self) -> np.dtype:
        return self._source.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        _, d1, d2 = self._source.shape
        return (self._n_frames, d1, d2)

    def set_io_threads(self, n: int) -> None:
        """Forward the IO thread budget to the wrapped source reader."""
        if hasattr(self._source, "set_io_threads"):
            self._source.set_io_threads(n)

    def _plane_index(self, i: int) -> int:
        """Normalize one plane-frame index against THIS view's length.

        Negative indices must wrap against ``n_frames`` (not the source
        length — with a ragged tail ``-1`` would otherwise land on another
        plane's frame), and out-of-range indices must raise like every
        other PMDDataset rather than silently reading past the declared
        temporal extent.
        """
        i0 = int(i)
        i = i0 + self._n_frames if i0 < 0 else i0
        if not 0 <= i < self._n_frames:
            raise IndexError(
                f"frame {i0} out of range for plane with {self._n_frames} frames"
            )
        return self._z + i * self._n_planes

    def _compute_at_indices(self, indices) -> np.ndarray:
        if isinstance(indices, int):
            global_idx: Union[list, slice] = [self._plane_index(indices)]
        elif isinstance(indices, slice):
            rng = range(*indices.indices(self.shape[0]))
            global_idx = [self._z + i * self._n_planes for i in rng]
        else:
            global_idx = [self._plane_index(i) for i in indices]
        src = self._source
        if hasattr(src, "_compute_at_indices"):
            out = np.asarray(src._compute_at_indices(global_idx))
        else:
            out = np.asarray(src[global_idx])
        if out.ndim == 2:  # single frame
            out = out[None]
        return out


class DeviceMovie:
    """A (T, d1, d2) movie resident in accelerator HBM (a jax.Array).

    For movies that fit on-device (or are generated on-device), this skips
    ALL host<->device streaming: the loader slices frames with device ops.
    Duck-types the frame-indexing subset of the PMDDataset contract but
    returns DEVICE arrays.
    """

    def __init__(self, array):
        import jax.numpy as jnp

        self._array = jnp.asarray(array)
        if self._array.ndim != 3:
            raise ValueError("DeviceMovie expects a (T, d1, d2) array")

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def ndim(self) -> int:
        return 3

    def __getitem__(self, item):
        import jax.numpy as jnp

        if isinstance(item, (list, np.ndarray, range)):
            idx = np.asarray(item)
            # jnp gather silently CLAMPS out-of-range indices (e.g.
            # movie[[0, T]] would return frame T-1); bounds-check on the
            # host first so DeviceMovie raises IndexError exactly like
            # PMDDataset/PlaneView — plane semantics must not depend on
            # whether the source was host- or device-resident.
            t = int(self._array.shape[0])
            if idx.size and (int(idx.min()) < -t or int(idx.max()) >= t):
                raise IndexError(
                    f"frame indices out of bounds for movie with {t} frames"
                )
            return self._array[jnp.asarray(idx)]
        return self._array[item]


def as_dataset(obj):
    """Normalize user input (PMDDataset | ndarray | jax.Array | path)."""
    if isinstance(obj, (PMDDataset, DeviceMovie)):
        return obj
    try:
        import jax

        if isinstance(obj, jax.Array):
            return DeviceMovie(obj)
    except ImportError:  # pragma: no cover
        pass
    if isinstance(obj, np.ndarray):
        return NumpyArray(obj)
    if isinstance(obj, str):
        if obj.endswith((".tif", ".tiff")):
            return TiffArray(obj)
        if obj.endswith(".npy"):
            return NpyArray(obj)
        raise ValueError(f"Cannot infer dataset type from path: {obj}")
    # Duck-typed: anything with shape + frame indexing (reference test_pmd.py:54)
    if hasattr(obj, "shape") and hasattr(obj, "__getitem__"):
        return obj
    raise TypeError(f"Cannot interpret {type(obj)} as a PMD dataset")
