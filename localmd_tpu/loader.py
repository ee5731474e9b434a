"""Streaming movie loader: statistics, background subtraction, V-projection.

Counterpart of the reference ``PMDLoader``
(reference pmd_loader.py:111-371). Differences by design:

- The reference computes per-pixel mean and Welch noise with a doubly nested
  host loop over 1024-frame chunks x sqrt(pixel_batch_size)^2 spatial tiles,
  dispatching one small jit per tile (reference pmd_loader.py:245-289). Here
  each 1024-frame chunk is ONE fused device program over the full FOV (the
  batched DFT-matmul Welch kernel in :mod:`localmd_tpu.ops.noise`).
- Transfers are bandwidth-aware: chunks move
  host->device CONTIGUOUS in the dataset's NATIVE dtype (half the bytes for
  uint16 two-photon data); transpose + f32 cast happen on device.
- IO prefetch: frame chunks are read on a background thread while the device
  crunches the previous chunk (replacing the torch DataLoader worker
  machinery, reference pmd_loader.py:151-168 — torch is not a dependency
  here).
- The streaming temporal regression ``v_projection`` folds the mixing matrix
  AND the per-pixel standardization into a single dense projector:
  V = P^T U^T ((X - mean)/std) = A~^T X - c with A~ = (U P)/std and
  c = A~^T mean. Each chunk is then ONE matmul — no sparse product
  (reference pmd_loader.py:316-346), no gather, no elementwise pass over
  the movie, and the result stays on device (no blocking device->host
  pull per chunk).

Statistics semantics match the reference exactly: mean accumulated over all
chunks; noise sigma averaged over chunks with >= 256 frames; zero sigmas
replaced by 1 (reference pmd_loader.py:203-291).
"""

from __future__ import annotations

import math
from functools import partial as functools_partial
import queue
import threading
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from localmd_tpu.dataset import as_dataset
from localmd_tpu.ops.linalg import truncated_random_svd
from localmd_tpu.ops.noise import (
    get_mean_and_noise,
    get_mean_and_noise_ref_compat,
    get_mean_chunk,
)
from localmd_tpu.ops.tiling import flatten_fov, flatten_image, unflatten_fov
from localmd_tpu.utils import ambient_device, display, is_device_oom, make_key
from localmd_tpu.utils.device import device_free_bytes

MIN_NOISE_FRAMES = 256  # reference pmd_loader.py:203 min_allowed_frames
STATS_CHUNK_FRAMES = 1024  # reference pmd_loader.py:171 frame_constant
# Cap on the f32 bytes a single streamed device chunk may occupy.
STREAM_CHUNK_BYTES = 1 << 30


def _mm(a, b):
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


def _chunk_ranges(
    total: int, chunk: int, merge_tail: bool = True
) -> List[Tuple[int, int]]:
    """[start, end) ranges. With ``merge_tail`` the final partial chunk is
    merged into the previous one (reference FrameDataloader semantics,
    pmd_loader.py:78-105) so every chunk except possibly the last-merged one
    has full length; without it, plain fixed-size ranges with a short tail
    (reference statistics-pass semantics, pmd_loader.py:245-258, where tails
    shorter than MIN_NOISE_FRAMES are then excluded from the noise average)."""
    n_chunks = math.ceil(total / chunk)
    if n_chunks <= 1:
        return [(0, total)]
    if not merge_tail:
        return [(i * chunk, min((i + 1) * chunk, total)) for i in range(n_chunks)]
    ranges = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks - 2)]
    ranges.append(((n_chunks - 2) * chunk, total))
    return ranges


def partition_ranges_for_host(
    ranges: List[Tuple[int, int]], host_index: int, host_count: int
) -> List[Tuple[int, int]]:
    """This host's CONTIGUOUS stripe of the chunk list — the multi-host
    input fan-out partition (docs/ARCHITECTURE.md §multi-host).

    Contiguous (not round-robin) so each host's output columns form one
    frames-axis shard of the global result — and the stripe boundaries use
    the SAME ceil-division jax's shardings use (shard h covers frames
    ``[h*ceil(T/H), min((h+1)*ceil(T/H), T))``), splitting chunks at the
    boundary, so ``jax.make_array_from_process_local_data`` receives
    exactly the local shard it expects. Trailing hosts may get an EMPTY
    stripe when T < (H-1)*ceil(T/H); consumers must handle zero chunks.

    Use ONLY for consumers whose per-chunk results are chunk-boundary-
    INSENSITIVE (the V regression: each frame's column is independent).
    The statistics pass is boundary-sensitive (per-chunk Welch sigma,
    MIN_NOISE_FRAMES tail drops, ``welch_compat='reference'`` nperseg=t_c)
    and must use :func:`partition_chunks_for_host` instead."""
    if host_count <= 1:
        return list(ranges)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    total = sum(b - a for a, b in ranges)
    shard = -(-total // host_count)
    lo = min(host_index * shard, total)
    hi = min(lo + shard, total)
    out: List[Tuple[int, int]] = []
    acc = 0
    for a, b in ranges:
        n = b - a
        s, e = max(acc, lo), min(acc + n, hi)
        if s < e:
            out.append((a + (s - acc), a + (e - acc)))
        acc += n
    return out


def partition_chunks_for_host(
    ranges: List[Tuple[int, int]], host_index: int, host_count: int
) -> List[Tuple[int, int]]:
    """This host's contiguous stripe of WHOLE chunks — no mid-chunk splits.

    The statistics pass partition: per-chunk Welch noise is chunk-boundary-
    sensitive (sigma is averaged per chunk, pieces shorter than
    MIN_NOISE_FRAMES drop out of the noise average, and
    ``welch_compat='reference'`` uses nperseg = t_c), so every host must see
    exactly the chunk boundaries the single-host loop would. Complete
    chunks are assigned in contiguous runs of ``ceil(n_chunks / host_count)``;
    stats has no shard-alignment requirement (the accumulators are
    additive). NOTE the ceil-division striping can leave trailing hosts
    idle whole chunks below a leading host's count (e.g. 4 chunks over 3
    hosts split 2/2/0) — acceptable for the stats pass, whose wall time is
    set by the busiest host's stripe. Trailing hosts may get an EMPTY
    stripe; consumers must handle zero chunks.

    NOTE the cross-host combination is a sum of per-host partial sums, so
    the float accumulation ASSOCIATES differently from the sequential
    single-host loop once any host holds more than one chunk: results agree
    to float32 ULP rounding (identical chunk partition), not bit-for-bit."""
    if host_count <= 1:
        return list(ranges)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    per = -(-len(ranges) // host_count)
    return list(ranges[host_index * per : (host_index + 1) * per])


def _cat_cols(results: List, n_rows: int):
    """Column-concat per-chunk results; an EMPTY list (a trailing host's
    empty multi-host stripe) yields the (n_rows, 0) shard the assembly
    expects rather than an IndexError."""
    if not results:
        return jnp.zeros((int(n_rows), 0), jnp.float32)
    return jnp.concatenate(results, axis=1) if len(results) > 1 else results[0]


class _PrefetchIter:
    """Background-thread prefetching iterator over ``load_fn(item)``.

    Abandoning the iterator mid-stream (an exception in the consumer loop,
    e.g. the pipeline's device-OOM retries) must not leak the worker: without
    a stop signal the thread would block on ``q.put`` forever, pinning its
    queued + in-flight device chunks in HBM — the very memory the OOM retry
    is trying to free. ``close()`` (also run by GC) sets the stop event and
    drains the queue, so the worker unblocks, drops its references, and
    exits.

    With ``eager=True`` the worker starts at CONSTRUCTION time instead of
    the first ``__next__``: callers can begin staging disk reads + async
    H2D transfers while unrelated device work runs (the pipeline overlaps
    the V-regression stream with the factorized-SVD projector chain this
    way, ``PMDLoader.start_v_prefetch``).
    """

    def __init__(self, make_items: Sequence, load_fn, depth: int = 2,
                 eager: bool = False):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: list = []
        self._stop = threading.Event()
        self._items = make_items
        self._load = load_fn
        self._done = False
        self._started = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        if eager:
            self._ensure_started()

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def _put(self, item) -> bool:
        """put honoring stop; False once the consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for item in self._items:
                if self._stop.is_set() or not self._put(self._load(item)):
                    return
        except BaseException as e:  # surface IO errors in the consumer
            self._err.append(e)
        finally:
            self._put(self._sentinel)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._stop.is_set():
            # after close() the worker refuses to enqueue (and the sentinel
            # may already have been drained) — a bare q.get() would block
            # forever; a closed iterator is simply exhausted
            raise StopIteration
        self._ensure_started()
        while True:
            try:
                got = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():  # cross-thread close mid-consumption
                    raise StopIteration
        if got is self._sentinel:
            self._done = True
            if self._err:
                raise self._err[0]
            raise StopIteration
        return got

    def close(self) -> None:
        stop = getattr(self, "_stop", None)  # __del__-safe if __init__ failed
        if stop is None:
            return
        stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    __del__ = close


def _prefetch_iter(make_items: Sequence, load_fn, depth: int = 2,
                   eager: bool = False) -> Iterable:
    return _PrefetchIter(make_items, load_fn, depth=depth, eager=eager)


@jax.jit
def _to_fov_f32(raw: Array) -> Array:
    """(T, d1, d2) native-dtype device chunk -> (d1, d2, T) float32."""
    return jnp.moveaxis(raw, 0, -1).astype(jnp.float32)


def _standardize_project(
    x: Array, mean_img: Array, std_img: Array, basis_flat: Array, order: str
) -> Tuple[Array, Array]:
    """Shared core: standardize a (d1, d2, t) f32 chunk and project out the
    background basis. Called inside jitted wrappers only."""
    d1, d2, t = x.shape
    x = (x - mean_img[:, :, None]) / std_img[:, :, None]
    flat = flatten_fov(x, order)
    temporal_projection = _mm(basis_flat.T, flat)
    flat = flat - _mm(basis_flat, temporal_projection)
    return unflatten_fov(flat, d1, d2, order), temporal_projection


@functools_partial(jax.jit, static_argnums=(4,))
def _standardize_and_filter_raw(
    raw: Array,
    mean_img: Array,
    std_img: Array,
    spatial_basis_flat: Array,
    order: str = "F",
) -> Tuple[Array, Array]:
    """Fused native-dtype (t, d1, d2) chunk -> standardized+filtered
    (d1, d2, t). One program: the cast/transpose/standardize/project chain
    never materializes eager intermediates — on a device-resident movie the
    eager version peaks at 4 movie-sized buffers and OOMs a 16 GB chip for
    1024^2 x 1024 inputs."""
    x = jnp.moveaxis(raw, 0, -1).astype(jnp.float32)
    return _standardize_project(x, mean_img, std_img, spatial_basis_flat, order)


@functools_partial(jax.jit, static_argnums=(5, 6))
def _background_basis_kernel(
    movie: Array,
    idx: Array,
    mean_img: Array,
    std_img: Array,
    key: Array,
    order: str,
    rank: int,
) -> Array:
    """Gather + standardize + flatten + randomized SVD as ONE program (for
    device-resident movies — an eager gather of ~1000 frames copies nearly
    the whole movie before the standardize even starts).

    The frame selection is a ``lax.scan`` of per-frame ``dynamic_slice``s,
    NOT a fancy gather: XLA lowers a many-row gather from a large 3-D
    operand through a layout-converted copy of the WHOLE movie (4 x 2 GB
    remat temps alongside the 8.6 GB movie at 1024^2 x 4096 uint16 — a
    compile-time HBM OOM, and chunking the gather doesn't help because each
    chunk still pays the full copy). Slices keep the peak at movie + the
    (d, n) standardized crop."""
    d1, d2 = movie.shape[1], movie.shape[2]

    def body(_, i):
        fr = jax.lax.dynamic_slice(movie, (i, 0, 0), (1, d1, d2))[0]
        fr = (fr.astype(jnp.float32) - mean_img) / std_img
        return None, flatten_image(fr, order)              # (d,)

    _, cols = jax.lax.scan(body, None, idx)                # (n, d)
    u, _, _ = truncated_random_svd(cols.T, key, rank)
    return u


@functools_partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def standardize_and_filter(
    data: Array,
    mean_img: Array,
    std_img: Array,
    spatial_basis_flat: Array,
    order: str = "F",
) -> Tuple[Array, Array]:
    """Standardize a (d1, d2, t) chunk and project out the background basis.

    ``order`` must match the pixel layout of ``spatial_basis_flat``'s rows.
    Returns the filtered chunk (d1, d2, t) and the background temporal
    projection (K, t). Parity: reference ``standardize_and_filter``
    (pmd_loader.py:374-389).
    """
    return _standardize_project(data, mean_img, std_img, spatial_basis_flat, order)


@functools_partial(jax.jit, donate_argnums=(0,))
def _write_time_chunk(buf: Array, chunk: Array, start: int) -> Array:
    """In-place (donated) write of a (d1, d2, t_c) chunk at time offset."""
    return jax.lax.dynamic_update_slice(buf, chunk, (0, 0, start))


@functools_partial(jax.jit, donate_argnums=(0,))
def _write_frame_chunk(buf: Array, chunk: Array, start: int) -> Array:
    """In-place (donated) write of a (t_c, d1, d2) native-dtype chunk into
    the HBM movie cache at frame offset ``start``."""
    return jax.lax.dynamic_update_slice(buf, chunk, (start, 0, 0))


@functools_partial(jax.jit, donate_argnums=(0,))
def _fold_projector(a: Array, std_flat: Array, mean_flat: Array):
    """(U P) -> (A~ = UP/std, c = A~^T mean); donates the UP buffer."""
    a_tilde = a / std_flat[:, None]
    c = _mm(a_tilde.T, mean_flat[:, None])[:, 0]
    return a_tilde, c


@functools_partial(jax.jit, static_argnums=(3,))
def _v_projection_kernel(a_tilde: Array, c: Array, raw: Array, order: str = "F") -> Array:
    """One streamed chunk of the folded temporal regression.

    raw: (t, d1, d2) native dtype. Returns (r', t) on device.
    """
    x = jnp.moveaxis(raw, 0, -1).astype(jnp.float32)      # (d1, d2, t)
    flat = flatten_fov(x, order)                           # (d, t)
    return _mm(a_tilde.T, flat) - c[:, None]


@functools_partial(jax.jit, static_argnums=(3, 4))
def _sharded_v_projection_kernel(
    a_tilde: Array, c: Array, raw: Array, order: str, mesh
) -> Array:
    """:func:`_v_projection_kernel` with the chunk's frame axis sharded over
    ``mesh``; the projector is replicated. Returns (r', t) frames-sharded."""
    from jax.sharding import PartitionSpec as P

    from localmd_tpu.parallel.mesh import BLOCK_AXIS

    f = jax.shard_map(
        lambda a, cc, r: _v_projection_kernel(a, cc, r, order),
        mesh=mesh,
        in_specs=(P(), P(), P(BLOCK_AXIS)),
        out_specs=P(None, BLOCK_AXIS),
        check_vma=False,
    )
    return f(a_tilde, c, raw)


class PMDLoader:
    """Owns dataset access, per-pixel statistics and the background basis."""

    def __init__(
        self,
        dataset,
        dtype: str = "float32",
        background_rank: int = 15,
        batch_size: int = 2000,
        pixel_batch_size: int = 5000,
        order: str = "F",
        compute_normalizer: bool = True,
        frame_constant: int = STATS_CHUNK_FRAMES,
        seed: Optional[int] = None,
        num_workers: Optional[int] = None,
        precomputed: Optional[dict] = None,
        welch_compat: str = "scipy",
        cache_movie="auto",
        cache_fraction: float = 0.5,
        np_rng=None,
        stats_started_hook=None,
    ):
        self.dataset = as_dataset(dataset)
        self.dtype = np.dtype(dtype)
        self.shape = tuple(self.dataset.shape)
        self.batch_size = batch_size
        # Accepted for reference API parity but intentionally inert: the
        # reference tiles the FOV into ~sqrt(pixel_batch_size)^2 spatial
        # tiles per stats chunk (pmd_loader.py:228-243); here the fused
        # kernel processes the whole FOV in one HBM pass, so there is
        # nothing to batch.
        self.pixel_batch_size = pixel_batch_size
        self._order = order
        self.background_rank = background_rank
        self.frame_constant = frame_constant
        self._compute_normalizer = compute_normalizer
        # "scipy": documented 256-sample-segment Welch semantics (default —
        # averages ~7 segments per 1024-frame chunk, the statistically
        # sounder estimate). "reference": reproduce the reference's
        # *effective* noise output — one full-chunk-length periodogram with
        # the hardcoded [65, 129) band (see
        # ops.noise.welch_noise_estimate_ref_compat) — for strict std_img /
        # end-to-end numerical parity with the reference package.
        if welch_compat not in ("scipy", "reference"):
            raise ValueError(
                f"welch_compat must be 'scipy' or 'reference', got {welch_compat!r}"
            )
        self.welch_compat = welch_compat
        # HBM movie cache: the pipeline streams the movie TWICE (stats pass
        # + V regression) through the host->device link — the binding
        # constraint whenever that link is slower than the chip. During the
        # stats pass, already-transferred chunks are retained on device in
        # NATIVE dtype (a prefix of the movie if the whole thing doesn't
        # fit), and later passes read those frames from HBM instead of
        # re-streaming them. "auto": cache as many leading frames as fit
        # ``cache_fraction`` of free HBM (needs device memory_stats; off
        # otherwise). True: always cache (budget-limited if memory_stats
        # exist). False: never. The reference has no equivalent — it streams
        # every pass from disk (reference pmd_loader.py:203-291, 316-346).
        self._cache_policy = cache_movie
        self._cache_fraction = float(cache_fraction)
        self._cache: Optional[jax.Array] = None
        self._cache_frames = 0
        self._v_prefetch: Optional[dict] = None
        # The device this loader's pipeline is pinned to (the thread-local
        # jax default at construction; None = process default). Prefetch
        # worker threads and memory budgets must use THIS, not devices()[0].
        self._device = ambient_device()
        self._key = make_key(seed)
        # numpy RNG for background frame sampling: a local RandomState keeps
        # seeded plane-parallel runs (threads) deterministic; the module
        # default matches the reference's global-np.random behavior.
        self._np_rng = np_rng if np_rng is not None else np.random
        # The reference spawns torch DataLoader worker *processes*
        # (pmd_loader.py:155-168); here IO is thread-based, so num_workers
        # maps onto prefetch depth and the native reader's thread count.
        self.num_workers = int(num_workers) if num_workers else 0
        # Queue depth is capped independently of the IO thread count (which
        # is forwarded via set_io_threads below): each queued item is a fully
        # materialized native-dtype chunk, so scaling depth with num_workers
        # would hold ~num_workers stream chunks in host RAM at once.
        self._prefetch_depth = max(2, min(self.num_workers, 4))
        if self.num_workers and hasattr(self.dataset, "set_io_threads"):
            self.dataset.set_io_threads(self.num_workers)

        # Fired once, right after the stats pass commits to its HBM cache
        # plan (i.e. the moment the long host->device streaming starts), as
        # hook(loader, cache_target_frames). The pipeline uses it to kick
        # off background AOT compilation of the block-stage program so the
        # program load overlaps the streaming (see localmd_tpu.aot).
        self._stats_started_hook = stats_started_hook

        # lazy host copies of mean/std (see _host_stats)
        self._mean_host: Optional[np.ndarray] = None
        self._std_host: Optional[np.ndarray] = None

        # checkpoint/resume hook: skip the statistics/background passes when
        # a prior run's results are supplied
        if precomputed and "mean_img" in precomputed:
            self.mean_img = np.asarray(precomputed["mean_img"])
            self.std_img = np.asarray(precomputed["std_img"])
        else:
            self._run_stats_with_oom_retry()
        if precomputed and "spatial_basis" in precomputed:
            self.spatial_basis = jnp.asarray(precomputed["spatial_basis"])
        else:
            self._initialize_background()

    @property
    def order(self) -> str:
        return self._order

    @property
    def n_pixels(self) -> int:
        return self.shape[1] * self.shape[2]

    # -- raw access -----------------------------------------------------------

    def temporal_crop(self, frames) -> np.ndarray:
        """(d1, d2, T) host array of the requested frames (reference
        pmd_loader.py:179-188)."""
        return self.dataset[frames].astype(self.dtype).transpose(1, 2, 0)

    @property
    def _device_resident(self) -> bool:
        from localmd_tpu.dataset import DeviceMovie

        return isinstance(self.dataset, DeviceMovie)

    # -- HBM movie cache --------------------------------------------------------

    def _plan_cache_frames(self) -> int:
        """How many leading frames to retain on device during the stats pass.

        Budget: live ``memory_stats`` free memory x ``cache_fraction``; with
        no memory statistics (e.g. the CPU backend) cache only on explicit
        ``cache_movie=True``, and then cache everything. Quantized down to
        whole stats chunks (partial chunks are never written, so a finer
        target would strand allocated device memory)."""
        if self._device_resident or not self._cache_policy:
            return 0
        t_total = self.shape[0]
        native = np.dtype(
            getattr(self.dataset, "raw_dtype", None) or self.dataset.dtype
        )
        per_frame = self.n_pixels * native.itemsize
        # the chip THIS pipeline is pinned to (volumetric devices= runs put
        # each plane on its own chip; chip 0's free memory is then the wrong
        # number to budget from)
        dev = self._device if self._device is not None else jax.devices()[0]
        free = device_free_bytes(dev)
        if free is None:
            return t_total if self._cache_policy is True else 0
        budget = int(free * self._cache_fraction)
        n = min(t_total, max(0, budget) // per_frame)
        if n < t_total:
            n = (n // self.frame_constant) * self.frame_constant
        # not worth the bookkeeping below a couple of stats chunks
        if n < min(t_total, 2 * self.frame_constant):
            return 0
        return int(n)

    def release_cache(self) -> None:
        """Drop the HBM movie cache (frees its device memory); subsequent
        reads stream from the dataset again."""
        if self._cache is not None:
            display(
                f"Releasing the HBM movie cache ({self._cache_frames} frames)"
            )
        self._cache = None
        self._cache_frames = 0
        if self._v_prefetch is not None:
            # the pending V-regression prefetch holds staged device chunks
            # and its chunk ranges were split at the now-dead cache boundary
            self._v_prefetch["iter"].close()
            self._v_prefetch = None

    def _cache_serves(self, frames) -> bool:
        """True iff ``frames`` lies entirely inside the cached prefix."""
        if self._cache is None or self._cache_frames == 0:
            return False
        # While the cache is being built, each donated write invalidates the
        # previous buffer; a prefetch thread slicing a stale reference would
        # hit a donated-buffer error. Serve only once construction is done.
        if getattr(self, "_cache_building", False):
            return False
        n = self._cache_frames
        if isinstance(frames, slice):
            start, stop, step = frames.indices(self.shape[0])
            return step == 1 and stop <= n
        if isinstance(frames, (int, np.integer)):
            # negative indices address the movie TAIL, not the cached prefix
            return 0 <= int(frames) < n
        arr = np.asarray(frames)
        return arr.size > 0 and int(arr.min()) >= 0 and int(arr.max()) < n

    def _load_raw(self, frames):
        """(T, d1, d2) chunk in the dataset's NATIVE dtype. For host datasets:
        a contiguous numpy array (cast + transpose happen on device). For a
        DeviceMovie or cached frames: a device slice (no transfer at all)."""
        if self._cache_serves(frames):
            if isinstance(frames, slice):
                arr = self._cache[frames]
            elif isinstance(frames, (int, np.integer)):
                arr = self._cache[int(frames)]
            else:
                arr = self._cache[jnp.asarray(np.asarray(frames))]
            return arr if arr.ndim == 3 else arr[None]
        if (
            self._device_resident
            and isinstance(frames, slice)
            and frames.start in (0, None)
            and frames.step in (1, None)
            and frames.stop is not None
            and frames.stop >= self.shape[0]
        ):
            # whole-movie request: jax slicing has no views, so even a full
            # slice would eagerly copy the entire movie in HBM
            return self.dataset._array
        arr = self.dataset[frames]
        if self._device_resident:
            return arr if arr.ndim == 3 else arr[None]
        arr = np.asarray(arr)
        if arr.ndim == 2:
            arr = arr[None]
        return np.ascontiguousarray(arr)

    def _stream_chunk_frames(self) -> int:
        from localmd_tpu.utils import transient_budget_bytes

        per_frame = self.n_pixels * 4
        # device-scaled chunk cap (HBM/16, 1 GiB floor): fewer, larger
        # dispatches on big-HBM chips; each queued chunk is one in-flight
        # H2D transfer so the prefetch depth still bounds peak footprint
        budget = max(STREAM_CHUNK_BYTES, transient_budget_bytes(self._device))
        return max(64, min(self.batch_size, budget // per_frame))

    def _iter_raw_chunks(
        self,
        chunk_frames: Optional[int] = None,
        prefetch: bool = True,
        merge_tail: bool = True,
        device_put: bool = False,
        host_partition=False,
        eager: bool = False,
    ):
        """Iterate native-dtype frame chunks.

        With ``device_put``, the prefetch thread also STARTS the host->device
        transfer (``jax.device_put`` is async): disk IO, H2D transfer, and
        device compute of the previous chunk all overlap — double buffering
        via the depth-2 prefetch queue. This is what sustains streaming
        throughput on full-movie passes (stats, V regression); the reference
        overlaps only disk IO via DataLoader workers (pmd_loader.py:155-168).

        With ``host_partition`` (the multi-host input fan-out point, see
        docs/ARCHITECTURE.md §multi-host), a ``jax.distributed`` run streams
        only THIS process's contiguous stripe of the chunk list — each host
        reads its own frames from shared storage, no cross-host data motion.
        ``True`` (or ``"frames"``) splits at the shard-aligned frame
        boundary (V regression); ``"chunks"`` assigns whole chunks only
        (statistics pass — per-chunk Welch noise is boundary-sensitive).
        Single-process runs are unaffected.
        """
        chunk_frames = chunk_frames or self._stream_chunk_frames()
        ranges = _chunk_ranges(self.shape[0], chunk_frames, merge_tail=merge_tail)
        if host_partition:
            n_proc = getattr(jax, "process_count", lambda: 1)()
            if n_proc > 1:
                part = (
                    partition_chunks_for_host
                    if host_partition == "chunks"
                    else partition_ranges_for_host
                )
                ranges = part(ranges, jax.process_index(), n_proc)
        if self._cache is not None and 0 < self._cache_frames < self.shape[0]:
            # split any range straddling the cache boundary so each chunk is
            # served wholly from HBM or wholly from the dataset
            c = self._cache_frames
            ranges = [
                piece
                for a, b in ranges
                for piece in ([(a, c), (c, b)] if a < c < b else [(a, b)])
            ]

        def load(rng):
            raw = self._load_raw(slice(rng[0], rng[1]))
            if device_put and not isinstance(raw, jax.Array):
                # Explicit target: ``jax.default_device`` is thread-local, so
                # the prefetch worker thread would otherwise stage every
                # chunk on the PROCESS default chip — wrong chip (and a
                # device->device hop) for plane-parallel volumetric runs.
                raw = jax.device_put(raw, self._device)
            return raw

        if prefetch and not self._device_resident:
            # In device_put mode cap the queue at 2 regardless of num_workers:
            # each queued item is an in-flight H2D transfer, and >~3 large
            # concurrent transfers congest the host link.
            depth = min(self._prefetch_depth, 2) if device_put else self._prefetch_depth
            return _prefetch_iter(ranges, load, depth=depth, eager=eager)
        return (load(r) for r in ranges)

    # -- V-regression stream overlap ---------------------------------------------

    def start_v_prefetch(self, mesh=None) -> bool:
        """Begin staging the V-regression pass's chunk stream NOW.

        The streaming temporal regression (``v_projection``) is the second
        full pass over the movie and cannot *compute* anything until the
        factorized-SVD projector exists — but its disk reads and async H2D
        transfers need nothing but the dataset. Starting the prefetch
        worker here lets those transfers ride the otherwise-idle host link
        while the projector chain computes, taking the projector's wall
        time off streaming runs for free. Results are identical — this
        only moves transfer time (the reference has no equivalent; its
        second pass starts cold, pmd_loader.py:316-346).

        Returns True if a prefetch was started (False when the movie is
        device-resident or fully HBM-cached — nothing to stream — or one
        is already pending)."""
        if self._device_resident or self._v_prefetch is not None:
            return False
        if 0 < self.shape[0] <= self._cache_frames:
            return False
        # Mirror v_projection's EFFECTIVE consumption mode: under multi-host
        # it rebinds mesh=None (per-host stripes run the plain kernel; the
        # global array is stitched at the end), so the stream must be staged
        # device_put=True there too or the handle always mismatches and the
        # overlap is silently inert exactly on multi-host runs.
        device_put = mesh is None or getattr(jax, "process_count", lambda: 1)() > 1
        it = self._iter_raw_chunks(
            device_put=device_put, host_partition=True, eager=True
        )
        if not isinstance(it, _PrefetchIter):  # pragma: no cover - defensive
            return False
        self._v_prefetch = {
            "iter": it,
            "device_put": device_put,
            "cache_frames": self._cache_frames,
        }
        return True

    def _take_v_prefetch(self, device_put: bool):
        """Hand the pending prefetch stream to ``v_projection`` — or None if
        its parameters no longer match (e.g. the HBM movie cache was dropped
        by an OOM retry after the stream started: its chunk ranges were
        split at the old cache boundary)."""
        h = self._v_prefetch
        self._v_prefetch = None
        if h is None:
            return None
        if h["device_put"] != device_put or h["cache_frames"] != self._cache_frames:
            h["iter"].close()
            return None
        return h["iter"]

    # -- statistics ------------------------------------------------------------

    def _run_stats_with_oom_retry(self):
        """Run the statistics pass; on a device OOM while the HBM movie cache
        was being built, drop the cache and recompute without it.

        The stats dispatches are async, so a RESOURCE_EXHAUSTED
        during them would otherwise surface at some later sync where the
        stats buffers are already poisoned and no retry can help. When a
        cache was built, one scalar sync here (a single D2H round trip, paid
        only on streaming runs whose wall time is transfer-dominated anyway)
        makes the failure surface at the one point where releasing the
        multi-GB cache can still save the run."""
        for attempt in (0, 1):
            try:
                self._initialize_normalizers()
                if self._cache is not None and not self._device_resident:
                    float(jnp.sum(self.mean_img) + jnp.sum(self.std_img))
                return
            except Exception as e:  # noqa: BLE001
                cache_was_up = (
                    self._cache is not None
                    or getattr(self, "_cache_building", False)
                )
                if not is_device_oom(e) or attempt or not cache_was_up:
                    raise
                display(
                    "WARNING: statistics pass hit device OOM; retrying "
                    "without the HBM movie cache"
                )
                self._cache_building = False
                self.release_cache()
                self._cache_policy = False

    def _initialize_normalizers(self):
        display("Computing video statistics (mean + noise sigma)")
        t_total, d1, d2 = self.shape
        normalizer_flag = self._compute_normalizer and t_total >= MIN_NOISE_FRAMES
        mean_acc = jnp.zeros((d1, d2), dtype=jnp.float32)
        noise_acc = jnp.zeros((d1, d2), dtype=jnp.float32)
        noise_chunks = 0

        multi_host = getattr(jax, "process_count", lambda: 1)() > 1
        if multi_host and self._cache_policy:
            # the cache stores a [0, n) frame PREFIX; under per-host chunk
            # stripes each process streams a different frame window, so the
            # prefix invariant (and every _cache_serves consumer) breaks
            display(
                "multi-host run: HBM movie cache disabled "
                "(per-host stats stripes)"
            )
            self._cache_policy = False
        cache_target = self._plan_cache_frames()
        self._cache_building = cache_target > 0
        hook = self._stats_started_hook
        if hook is not None:
            self._stats_started_hook = None  # fire once (OOM retry reruns this)
            try:
                hook(self, cache_target)
            except Exception:  # noqa: BLE001 - a warm-up hook must not kill stats
                pass
        pos = 0
        # Unmerged ranges: the reference stats loop walks plain 1024-frame
        # ranges and excludes short (< MIN_NOISE_FRAMES) tails from the noise
        # average (pmd_loader.py:245-258); merged ranges would fold the tail
        # into the last chunk and shift std_img whenever T % 1024 != 0.
        # host_partition="chunks": under jax.distributed each process streams
        # only its contiguous stripe of WHOLE stats chunks (identity
        # single-process); per-chunk Welch noise is chunk-boundary-sensitive
        # (sigma averaged per chunk, MIN_NOISE_FRAMES tail drops, reference
        # nperseg = t_c), so mid-chunk splits would materially shift std_img —
        # whole chunks keep the partition identical to the single-host loop.
        # The accumulators are additive, so one tiny cross-host allgather
        # below completes the pass (docs/ARCHITECTURE.md §multi-host).
        for raw in self._iter_raw_chunks(
            self.frame_constant, merge_tail=False, device_put=True,
            host_partition="chunks",
        ):
            t_c = raw.shape[0]
            if cache_target and pos + t_c <= cache_target:
                # retain this already-transferred chunk on device: later
                # passes (init-frame load, V regression) read it from HBM
                # instead of re-streaming through the host link
                raw = jnp.asarray(raw)
                if self._cache is None:
                    self._cache = jnp.zeros((cache_target, d1, d2), raw.dtype)
                self._cache = _write_frame_chunk(self._cache, raw, pos)
                self._cache_frames = pos + t_c
            pos += t_c
            with_noise = normalizer_flag and t_c >= MIN_NOISE_FRAMES
            chunk = _to_fov_f32(jnp.asarray(raw))
            if with_noise and self.welch_compat == "reference":
                m, sig = get_mean_and_noise_ref_compat(chunk, t_total)
            elif with_noise:
                m, sig = get_mean_and_noise(chunk, t_total)
            else:
                m = get_mean_chunk(chunk, t_total)
            if with_noise:
                noise_acc = noise_acc + sig
                noise_chunks += 1
            mean_acc = mean_acc + m

        if multi_host:
            # Cross-host reduction of the additive accumulators — the ONLY
            # stats traffic that crosses hosts: two (d1, d2) images + one
            # scalar per process (frame chunks themselves never move). The
            # chunk PARTITION is identical to the single-host loop (whole
            # chunks per host), but the float sums associate differently
            # (per-host partials, then process order) once a host holds more
            # than one chunk — agreement is to f32 ULP rounding, and exactly
            # bit-identical only when every host holds at most one chunk.
            from jax.experimental import multihost_utils

            gathered = multihost_utils.process_allgather(
                {
                    "mean": np.asarray(mean_acc),
                    "noise": np.asarray(noise_acc),
                    "chunks": np.int64(noise_chunks),
                }
            )
            mean_acc = jnp.asarray(gathered["mean"].sum(axis=0))
            noise_acc = jnp.asarray(gathered["noise"].sum(axis=0))
            noise_chunks = int(gathered["chunks"].sum())

        self._cache_building = False
        if self._cache is not None and self._cache_frames:
            display(
                f"HBM movie cache: retaining {self._cache_frames}/{t_total} "
                f"frames on device (native dtype)"
            )
        # mean/std stay DEVICE-resident: every consumer standardizes on
        # device, and each eager host pull is a blocking copy on the
        # pipeline critical path (PMDArray materializes them lazily).
        self.mean_img = mean_acc
        if normalizer_flag and noise_chunks > 0:
            std = noise_acc / np.float32(noise_chunks)
            std = jnp.where(std == 0, jnp.float32(1.0), std)
        else:
            std = jnp.ones((d1, d2), dtype=jnp.float32)
        self.std_img = std
        display("Finished mean and noise estimation")

    # -- background ------------------------------------------------------------

    def _initialize_background(self, n_samples: int = 1000):
        """Rank-``background_rank`` randomized SVD of <= 1000 random
        standardized frames (reference pmd_loader.py:300-314). The basis rows
        follow the loader's pixel ``order``: shape (d1*d2, K), on device."""
        if self.background_rank <= 0:
            self.spatial_basis = jnp.zeros((self.n_pixels, 1), dtype=jnp.float32)
            return
        display("Computing low-rank background basis")
        t_total = self.shape[0]
        n = min(n_samples, t_total)
        frames = np.sort(self._np_rng.choice(t_total, size=n, replace=False)).tolist()
        self._key, sub = jax.random.split(self._key)
        if self._device_resident:
            # one fused program: gather + standardize + rSVD (eager gather of
            # ~1000 frames would copy nearly the whole movie)
            self.spatial_basis = _background_basis_kernel(
                self.dataset._array,
                jnp.asarray(frames),
                jnp.asarray(self.mean_img),
                jnp.asarray(self.std_img),
                sub,
                self._order,
                self.background_rank,
            )
            return
        crop = _to_fov_f32(jnp.asarray(self._load_raw(frames)))
        crop = (crop - jnp.asarray(self.mean_img)[:, :, None]) / jnp.asarray(
            self.std_img
        )[:, :, None]
        flat = flatten_fov(crop, self._order)
        u, _, _ = truncated_random_svd(flat, sub, self.background_rank)
        self.spatial_basis = u

    # -- standardized views -----------------------------------------------------

    def _host_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of mean/std, pulled once and cached (mean_img/std_img
        are device-resident; repeated ``np.asarray`` would pay a blocking
        D2H round trip per call)."""
        if self._mean_host is None:
            self._mean_host = np.asarray(self.mean_img)
            self._std_host = np.asarray(self.std_img)
        return self._mean_host, self._std_host

    def temporal_crop_standardized(self, frames) -> np.ndarray:
        crop = self.temporal_crop(frames)
        mean, std = self._host_stats()
        crop = (crop - mean[:, :, None]) / std[:, :, None]
        return crop.astype(self.dtype)

    def temporal_crop_with_filter(self, frames) -> Tuple[Array, Array]:
        """Standardize + background-filter the init frames.

        Returns DEVICE arrays: filtered data (d1, d2, T) and background
        temporal basis (K, T). Processed in bounded temporal chunks
        (reference pmd_loader.py:348-371); chunks are written into a single
        DONATED device buffer so peak HBM is output + one chunk (a
        concatenate would transiently double the output).
        """
        mean_d = jnp.asarray(self.mean_img)
        std_d = jnp.asarray(self.std_img)
        basis_d = jnp.asarray(self.spatial_basis)
        t = len(frames)
        d1, d2 = self.shape[1], self.shape[2]
        chunk_frames = self._stream_chunk_frames()

        spans = list(range(0, t, chunk_frames))
        contiguous = list(frames) == list(range(frames[0], frames[0] + t))

        def load(s):
            sub = (
                slice(frames[0] + s, frames[0] + min(s + chunk_frames, t))
                if contiguous
                else frames[s : s + chunk_frames]
            )
            return self._load_raw(sub)

        if len(spans) == 1:
            # fused: cast/transpose/standardize/filter in ONE program (no
            # eager movie-sized intermediate; matters for device-resident
            # movies near the HBM limit)
            return _standardize_and_filter_raw(
                jnp.asarray(load(0)), mean_d, std_d, basis_d, self._order
            )

        buf = jnp.zeros((d1, d2, t), dtype=jnp.float32)
        tb_chunks = []
        loader = (
            _prefetch_iter(spans, load, depth=self._prefetch_depth)
            if not self._device_resident
            else (load(s) for s in spans)
        )
        for start, raw in zip(spans, loader):
            filt, tb = _standardize_and_filter_raw(
                jnp.asarray(raw), mean_d, std_d, basis_d, self._order
            )
            buf = _write_time_chunk(buf, filt, start)
            tb_chunks.append(tb)
        return buf, jnp.concatenate(tb_chunks, axis=1)

    # -- streaming temporal regression ------------------------------------------

    def prepare_vproj_cells(self, u):
        """Build (and stash) the cell chunk kernel's packed operands for
        ``u`` (blocksparse.build_vproj_cells). Needs only U + the
        statistics images — NOT the mixing matrix — so the pipeline calls
        this right after U is assembled: the build is dispatched
        under the blocking counts pull / projector chain instead of the
        V-regression critical path. Idempotent per ``u`` (keyed on the
        panels buffer identity); returns (m_cell, q)."""
        from localmd_tpu.blocksparse import build_vproj_cells

        stash = getattr(self, "_vproj_cells", None)
        if stash is not None and stash[0] is u.panels:
            return stash[1], stash[2]
        d1, d2 = self.shape[1], self.shape[2]
        m_cell, q = build_vproj_cells(
            u.panels, u.rows, (d1, d2), self._order,
            tuple(int(v) for v in u.cell_geom),
            u.dense_basis,
            flatten_image(jnp.asarray(self.std_img), self._order),
            flatten_image(jnp.asarray(self.mean_img), self._order),
        )
        self._vproj_cells = (u.panels, m_cell, q)
        return m_cell, q

    def v_projection(self, u, p: Array, mesh=None) -> Array:
        """V = P^T U^T standardize(movie): second full streaming pass.

        Args:
            u: BlockSparseMatrix spatial basis (padded columns fine).
            p: (R, r') mixing matrix — U @ P has orthonormal columns.
            mesh: optional 1-D jax Mesh — frames-axis data parallelism
                (zero collectives; reference SURVEY §5's "long axis").

        Returns:
            (r', T) DEVICE array (pull to host lazily).
        """
        p_dev = jnp.asarray(p)
        std_flat = flatten_image(jnp.asarray(self.std_img), self._order)
        mean_flat = flatten_image(jnp.asarray(self.mean_img), self._order)

        multi_host = getattr(jax, "process_count", lambda: 1)() > 1
        mesh_for_assembly = mesh
        if mesh is not None and multi_host:
            # per-host stripes are process-LOCAL arrays; frames-parallel V
            # needs zero collectives, so each host runs the plain kernel
            # (or the cell kernel below) on its stripe and the
            # global result is stitched at the end
            # (docs/ARCHITECTURE.md §multi-host)
            mesh = None

        from localmd_tpu.blocksparse import (
            coset_vproj_chunk,
            coset_vproj_eligible,
        )

        if mesh is None and coset_vproj_eligible(u):
            # Cell fast path: V = P^T (U~^T X) via one canonical batched
            # dot per raw chunk against the packed per-cell panels — the
            # (d, r') canvas a = U @ P is never built (see
            # blocksparse.coset_vproj_chunk). Same chunk stream / prefetch /
            # multi-host stripe semantics as the dense path below.
            geom = tuple(int(v) for v in u.cell_geom)
            m_cell, q = self.prepare_vproj_cells(u)
            n1, n2, h1, h2 = geom
            s_slots = int(u.panels.shape[2])
            results = []
            chunks = self._take_v_prefetch(True) or self._iter_raw_chunks(
                device_put=True, host_partition=True
            )
            try:
                for raw in chunks:
                    results.append(
                        coset_vproj_chunk(
                            m_cell, q, p_dev, jnp.asarray(raw),
                            n1, n2, h1, h2, s_slots,
                        )
                    )
            finally:
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()
            return self._assemble_global_v(
                _cat_cols(results, p_dev.shape[1]), mesh_for_assembly
            )

        a = u.matmul(p_dev)                                   # (d, r') dense
        a_tilde, c = _fold_projector(a, std_flat, mean_flat)  # donates a

        order = self._order

        def kernel(a_t, c_r, raw):
            return _v_projection_kernel(a_t, c_r, raw, order)

        n_dev = 1
        if mesh is not None:
            n_dev = mesh.devices.size

            def kernel(a_t, c_r, raw):
                return _sharded_v_projection_kernel(a_t, c_r, raw, order, mesh)

        results = []
        chunks = self._take_v_prefetch(mesh is None) or self._iter_raw_chunks(
            device_put=(mesh is None), host_partition=True
        )
        try:
            for raw in chunks:
                raw = jnp.asarray(raw)
                t_c = raw.shape[0]
                pad = (-t_c) % n_dev
                if pad:
                    raw = jnp.concatenate([raw, raw[:pad]], axis=0)
                out = kernel(a_tilde, c, raw)
                results.append(out[:, :t_c] if pad else out)
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()
        return self._assemble_global_v(
            _cat_cols(results, a_tilde.shape[1]), mesh_for_assembly
        )

    def _assemble_global_v(self, local_v: Array, mesh) -> Array:
        """Multi-host assembly point (docs/ARCHITECTURE.md §multi-host): in
        a ``jax.distributed`` run each process computed the V columns of its
        own contiguous frame stripe; stitch them into one frames-sharded
        global array — the stripes ARE the shards, so no V bytes cross
        hosts. Single-process runs: identity."""
        n_proc = getattr(jax, "process_count", lambda: 1)()
        if n_proc <= 1:
            return local_v
        if mesh is None or mesh.devices.size < n_proc:
            raise ValueError(
                "multi-host v_projection needs a host-spanning mesh so the "
                "per-host V stripes can be assembled into one global array "
                "(see docs/ARCHITECTURE.md, multi-host input fan-out)"
            )
        from jax.sharding import NamedSharding, PartitionSpec as P

        from localmd_tpu.parallel.mesh import BLOCK_AXIS

        sharding = NamedSharding(mesh, P(None, BLOCK_AXIS))
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(local_v), (local_v.shape[0], self.shape[0])
        )
