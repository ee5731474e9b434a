import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localmd_tpu.dataset import DeviceMovie, as_dataset
from localmd_tpu.loader import (
    PMDLoader,
    _chunk_ranges,
    _prefetch_iter,
    standardize_and_filter,
)
from localmd_tpu.ops.noise import welch_noise_estimate


class TestChunkRanges:
    def test_merges_final_chunk(self):
        # reference FrameDataloader semantics (pmd_loader.py:78-105): the
        # final chunk is ALWAYS merged into the previous one (even when full)
        assert _chunk_ranges(10, 4) == [(0, 4), (4, 10)]
        assert _chunk_ranges(8, 4) == [(0, 8)]
        assert _chunk_ranges(3, 4) == [(0, 3)]
        assert _chunk_ranges(12, 4) == [(0, 4), (4, 12)]
        # every chunk covers, no overlap
        for total, chunk in [(1000, 128), (1024, 1024), (2047, 1024)]:
            ranges = _chunk_ranges(total, chunk)
            assert ranges[0][0] == 0 and ranges[-1][1] == total
            for (a, b), (c, d) in zip(ranges, ranges[1:]):
                assert b == c

    def test_min_chunk_length_for_noise(self):
        # the merged last chunk is always >= chunk (except single-chunk case),
        # so the reference's 256-frame noise guard stays satisfied
        for total in range(1025, 3000, 173):
            ranges = _chunk_ranges(total, 1024)
            assert all(b - a >= 1024 for a, b in ranges)


class TestPrefetchIter:
    def test_order_preserved(self):
        items = list(range(20))
        out = list(_prefetch_iter(items, lambda x: x * 2))
        assert out == [x * 2 for x in items]

    def test_errors_propagate(self):
        def bad(x):
            if x == 3:
                raise RuntimeError("boom")
            return x

        with pytest.raises(RuntimeError, match="boom"):
            list(_prefetch_iter(range(10), bad))

    def test_abandoned_iterator_stops_worker(self):
        # An OOM retry abandons the iterator mid-stream; the worker thread
        # must unblock (it would otherwise sit on q.put forever, pinning its
        # in-flight device chunks) and stop consuming the source.
        import time

        produced = []

        def load(i):
            produced.append(i)
            return i

        it = _prefetch_iter(range(1000), load, depth=2)
        assert next(it) == 0
        it.close()  # what GC does when the consumer loop raises
        time.sleep(0.5)
        n = len(produced)
        assert n < 10  # worker stopped early, not drained the source
        time.sleep(0.3)
        assert len(produced) == n  # ...and stays stopped

    def test_eager_start_produces_before_first_next(self):
        # eager=True is the V-regression overlap hook: the worker must begin
        # loading at construction time, not at the first __next__
        import time

        produced = []

        def load(i):
            produced.append(i)
            return i

        it = _prefetch_iter(range(10), load, depth=2, eager=True)
        deadline = time.time() + 5.0
        while not produced and time.time() < deadline:
            time.sleep(0.01)
        assert produced  # started without any consumer pull
        assert list(it) == list(range(10))  # order + completeness intact

    def test_prefetch_chunks_pinned_to_ambient_device(self, rng):
        # The prefetch worker is a new thread, so jax's thread-local default
        # device does NOT apply inside it; the loader must pin device_put
        # explicitly or plane-parallel volumetric runs stage every chunk on
        # chip 0.
        import jax

        devs = jax.devices()
        movie = rng.standard_normal((40, 8, 8)).astype(np.float32)
        with jax.default_device(devs[1]):
            loader = PMDLoader(
                movie, background_rank=0, compute_normalizer=False, seed=0
            )
            chunks = list(
                loader._iter_raw_chunks(chunk_frames=10, device_put=True)
            )
        assert len(chunks) >= 2
        for c in chunks:
            assert list(c.devices())[0] == devs[1]


class TestLoaderStatistics:
    def test_mean_and_sigma_on_known_noise(self, rng):
        t, d1, d2 = 1100, 12, 10
        mean_true = rng.random((d1, d2)).astype(np.float32) * 10
        sigma_true = 2.5
        movie = mean_true[None] + sigma_true * rng.standard_normal(
            (t, d1, d2)
        ).astype(np.float32)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        np.testing.assert_allclose(loader.mean_img, movie.mean(axis=0), rtol=1e-4)
        np.testing.assert_allclose(loader.std_img.mean(), sigma_true, rtol=0.1)

    def test_short_movie_skips_normalizer(self, rng):
        movie = rng.standard_normal((100, 12, 10)).astype(np.float32)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        np.testing.assert_array_equal(loader.std_img, 1.0)

    def test_compute_normalizer_false(self, rng):
        movie = rng.standard_normal((400, 12, 10)).astype(np.float32)
        loader = PMDLoader(movie, background_rank=0, compute_normalizer=False, seed=0)
        np.testing.assert_array_equal(loader.std_img, 1.0)

    def test_stats_tail_semantics(self, rng):
        """The stats pass walks UNMERGED frame_constant ranges and excludes
        short (< MIN_NOISE_FRAMES) tails from the noise average (reference
        pmd_loader.py:245-258): a 176-frame tail contributes to the mean but
        not to std_img."""
        t, d1, d2 = 1200, 8, 6  # 1024 + 176-frame tail (176 < 256)
        movie = rng.standard_normal((t, d1, d2)).astype(np.float32) * 3.0
        loader = PMDLoader(movie, background_rank=0, seed=0)
        # mean over ALL frames
        np.testing.assert_allclose(loader.mean_img, movie.mean(axis=0), rtol=1e-4)
        # noise sigma from the single full 1024-frame chunk only
        chunk = jnp.moveaxis(jnp.asarray(movie[:1024]), 0, -1)
        expected_sigma = np.asarray(welch_noise_estimate(chunk))
        np.testing.assert_allclose(loader.std_img, expected_sigma, rtol=1e-4)

    def test_precomputed_skips_passes(self, rng):
        movie = rng.standard_normal((400, 12, 10)).astype(np.float32)
        mean = np.full((12, 10), 7.0, np.float32)
        std = np.full((12, 10), 3.0, np.float32)
        basis = np.zeros((120, 1), np.float32)
        loader = PMDLoader(
            movie, background_rank=1, seed=0,
            precomputed={"mean_img": mean, "std_img": std, "spatial_basis": basis},
        )
        np.testing.assert_array_equal(loader.mean_img, mean)
        np.testing.assert_array_equal(np.asarray(loader.spatial_basis), basis)


class TestStandardizeAndFilter:
    def test_background_removed(self, rng):
        d1, d2, t, k = 8, 6, 50, 2
        data = rng.standard_normal((d1, d2, t)).astype(np.float32)
        mean = np.zeros((d1, d2), np.float32)
        std = np.ones((d1, d2), np.float32)
        basis = np.linalg.qr(rng.standard_normal((d1 * d2, k)))[0].astype(np.float32)
        filt, tb = standardize_and_filter(
            jnp.asarray(data), jnp.asarray(mean), jnp.asarray(std), jnp.asarray(basis)
        )
        # filtered data orthogonal to the basis
        from localmd_tpu.ops.tiling import flatten_fov

        flat = np.asarray(flatten_fov(filt))
        np.testing.assert_allclose(basis.T @ flat, 0.0, atol=1e-4)
        assert tb.shape == (k, t)


class TestHostStatsCache:
    def test_host_stats_pulled_once(self, rng):
        """temporal_crop_standardized uses cached host mean/std — repeated
        calls must not re-pull the device-resident images (a blocking D2H
        copy per call)."""
        movie = rng.standard_normal((300, 10, 10)).astype(np.float32)
        load_obj = PMDLoader(movie, seed=0)
        m1, s1 = load_obj._host_stats()
        m2, s2 = load_obj._host_stats()
        assert m1 is m2 and s1 is s2  # same host objects, no second pull
        crop = load_obj.temporal_crop_standardized(list(range(20)))
        expected = (
            movie[:20].transpose(1, 2, 0) - m1[:, :, None]
        ) / s1[:, :, None]
        np.testing.assert_allclose(crop, expected, rtol=1e-5)


class TestHostPartition:
    """Multi-host input fan-out: the chunk list splits into contiguous,
    frame-balanced per-host stripes (docs/ARCHITECTURE.md §multi-host)."""

    def test_single_host_identity(self):
        from localmd_tpu.loader import _chunk_ranges, partition_ranges_for_host

        r = _chunk_ranges(10000, 1024)
        assert partition_ranges_for_host(r, 0, 1) == r

    @pytest.mark.parametrize("total,chunk,hosts", [
        (30000, 1024, 4), (30000, 1024, 8), (1000, 300, 3), (5, 2, 4),
        (2048, 1024, 8),  # more hosts than chunks: chunks split, tails empty
    ])
    def test_stripes_cover_disjoint_contiguous(self, total, chunk, hosts):
        from localmd_tpu.loader import _chunk_ranges, partition_ranges_for_host

        ranges = _chunk_ranges(total, chunk)
        stripes = [partition_ranges_for_host(ranges, h, hosts) for h in range(hosts)]
        # stripes cover every frame exactly once, in order
        flat = [f for s in stripes for a, b in s for f in range(a, b)]
        assert flat == list(range(total))
        # contiguity: each stripe's frames form one interval
        for s in stripes:
            for (a1, b1_), (a2, _) in zip(s, s[1:]):
                assert b1_ == a2
        # stripe boundaries are jax's ceil-division shard boundaries, so
        # the per-host columns ARE the frames-axis shards at assembly
        shard = -(-total // hosts)
        for h, s in enumerate(stripes):
            lo, hi = min(h * shard, total), min((h + 1) * shard, total)
            if lo == hi:
                assert s == []
            else:
                assert s[0][0] == lo and s[-1][1] == hi

    def test_bad_host_index_raises(self):
        from localmd_tpu.loader import partition_ranges_for_host

        with pytest.raises(ValueError):
            partition_ranges_for_host([(0, 10)], 4, 4)

    def test_chunk_partition_never_splits_chunks(self):
        # the STATS partition: per-chunk Welch noise is chunk-boundary-
        # sensitive, so hosts receive whole chunks only — the union of all
        # stripes is exactly the single-host chunk list, chunk-for-chunk
        from localmd_tpu.loader import _chunk_ranges, partition_chunks_for_host

        for total, chunk, hosts in [
            (10000, 1024, 2),   # ceil(T/H) not a multiple of chunk
            (30000, 1024, 4),
            (1000, 300, 3),
            (2048, 1024, 8),    # more hosts than chunks: tails empty
        ]:
            ranges = _chunk_ranges(total, chunk)
            stripes = [
                partition_chunks_for_host(ranges, h, hosts)
                for h in range(hosts)
            ]
            assert [r for s in stripes for r in s] == ranges
            # every assigned range IS one of the single-host chunks (no split)
            for s in stripes:
                for r in s:
                    assert r in ranges

    def test_chunk_partition_identity_and_bounds(self):
        from localmd_tpu.loader import partition_chunks_for_host

        assert partition_chunks_for_host([(0, 5)], 0, 1) == [(0, 5)]
        with pytest.raises(ValueError):
            partition_chunks_for_host([(0, 5)], 2, 2)

    def test_v_projection_unchanged_single_process(self, rng):
        # the host_partition flag must be a no-op with process_count == 1
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        movie = (rng.standard_normal((300, 20, 20)) + 4).astype(np.float32)
        grid = BlockGrid(20, 20, (10, 10))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 3)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), 400,
            jnp.zeros((400, 1), jnp.float32),
        )
        p = rng.standard_normal((u.shape[1], 5)).astype(np.float32)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        v = np.asarray(loader.v_projection(u, jnp.asarray(p)))
        assert v.shape == (5, 300)


class TestCosetVProjection:
    """The coset-view V-projection fast path (regular grids, flag-forced on
    CPU) must match the default folded-projector kernel."""

    @pytest.mark.parametrize("k_bg,order", [(2, "F"), (0, "F"), (2, "C")])
    def test_coset_vproj_matches_default(self, rng, k_bg, order):
        import localmd_tpu.blocksparse as bs
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        t, d = 130, 24
        movie = (rng.standard_normal((t, d, d)) + 4).astype(np.float32)
        grid = BlockGrid(d, d, (12, 12), order=order)
        assert grid.cell_geometry() is not None
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 3)
        ).astype(np.float32)
        bg = rng.standard_normal((d * d, k_bg)).astype(np.float32) * 0.1
        u_plain = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), d * d,
            jnp.asarray(bg), block_shape=(12, 12),
            coset_info=grid.coset_info(),
        )
        u_coset = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), d * d,
            jnp.asarray(bg), block_shape=(12, 12),
            coset_info=grid.coset_info(), cell_geom=grid.cell_geometry(),
        )
        p = jnp.asarray(
            rng.standard_normal((u_plain.shape[1], 5)).astype(np.float32)
        )
        loader = PMDLoader(movie, background_rank=0, seed=0, order=order)
        v_ref = np.asarray(loader.v_projection(u_plain, p))
        orig = bs.COSET_VPROJ
        bs.COSET_VPROJ = True
        try:
            assert bs.coset_vproj_eligible(u_coset)
            assert not bs.coset_vproj_eligible(u_plain)
            v_coset = np.asarray(
                PMDLoader(
                    movie, background_rank=0, seed=0, order=order
                ).v_projection(u_coset, p)
            )
        finally:
            bs.COSET_VPROJ = orig
        scale = max(np.abs(v_ref).max(), 1.0)
        np.testing.assert_allclose(
            v_coset / scale, v_ref / scale, atol=3e-5
        )

    def test_coset_vproj_streams_chunks(self, rng):
        # multi-chunk streaming (tiny chunk budget) must agree with the
        # one-shot result
        import localmd_tpu.blocksparse as bs
        import localmd_tpu.loader as loader_mod
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        t, d = 90, 24
        movie = (rng.standard_normal((t, d, d)) + 4).astype(np.float32)
        grid = BlockGrid(d, d, (12, 12))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 2)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), d * d,
            jnp.zeros((d * d, 1), jnp.float32), block_shape=(12, 12),
            coset_info=grid.coset_info(), cell_geom=grid.cell_geometry(),
        )
        p = jnp.asarray(
            rng.standard_normal((u.shape[1], 4)).astype(np.float32)
        )
        orig = bs.COSET_VPROJ
        bs.COSET_VPROJ = True
        try:
            one = np.asarray(
                PMDLoader(movie, background_rank=0, seed=0).v_projection(u, p)
            )
            ld = PMDLoader(movie, background_rank=0, seed=0)
            orig_chunk = loader_mod.PMDLoader._stream_chunk_frames
            loader_mod.PMDLoader._stream_chunk_frames = lambda self: 40
            try:
                chunked = np.asarray(ld.v_projection(u, p))
            finally:
                loader_mod.PMDLoader._stream_chunk_frames = orig_chunk
        finally:
            bs.COSET_VPROJ = orig
        np.testing.assert_allclose(chunked, one, rtol=1e-5, atol=1e-5)


class TestVPrefetchOverlap:
    """start_v_prefetch stages the V-regression stream while the projector
    chain computes; results must be identical and the handle lifecycle safe."""

    def _setup(self, rng, t=300, d=20):
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        movie = (rng.standard_normal((t, d, d)) + 4).astype(np.float32)
        grid = BlockGrid(d, d, (10, 10))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 3)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), d * d,
            jnp.zeros((d * d, 1), jnp.float32),
        )
        p = jnp.asarray(rng.standard_normal((u.shape[1], 5)).astype(np.float32))
        return movie, u, p

    def test_prefetched_v_projection_identical(self, rng):
        movie, u, p = self._setup(rng)
        base = PMDLoader(movie, background_rank=0, seed=0)
        v_ref = np.asarray(base.v_projection(u, p))

        loader = PMDLoader(movie, background_rank=0, seed=0)
        assert loader.start_v_prefetch() is True
        assert loader._v_prefetch is not None
        v = np.asarray(loader.v_projection(u, p))
        assert loader._v_prefetch is None  # consumed, not leaked
        np.testing.assert_array_equal(v, v_ref)

    def test_next_after_close_raises_stopiteration(self):
        # close() may consume the sentinel while draining; a later __next__
        # must not block on an empty queue forever (latent deadlock)
        from localmd_tpu.loader import _PrefetchIter

        it = _PrefetchIter([1, 2, 3], lambda x: x, depth=1)
        assert next(it) == 1
        it.close()
        with pytest.raises(StopIteration):
            next(it)

    def test_cross_thread_close_unblocks_consumer(self):
        import threading
        import time as _time

        from localmd_tpu.loader import _PrefetchIter

        release = threading.Event()

        def slow(x):
            if x > 0:
                release.wait(10)  # starve the queue so __next__ blocks
            return x

        it = _PrefetchIter([0, 1, 2], slow, depth=1)
        assert next(it) == 0
        got = []

        def consume():
            try:
                next(it)
                got.append("item")
            except StopIteration:
                got.append("stop")

        t = threading.Thread(target=consume)
        t.start()
        _time.sleep(0.2)
        it.close()  # must wake the blocked consumer
        t.join(5)
        release.set()
        assert not t.is_alive()
        assert got == ["stop"]

    def test_double_start_is_noop(self, rng):
        movie, u, p = self._setup(rng)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        assert loader.start_v_prefetch() is True
        handle = loader._v_prefetch
        assert loader.start_v_prefetch() is False  # one already pending
        assert loader._v_prefetch is handle

    def test_release_cache_invalidates_pending_prefetch(self, rng):
        movie, u, p = self._setup(rng)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        assert loader.start_v_prefetch() is True
        it = loader._v_prefetch["iter"]
        loader.release_cache()
        assert loader._v_prefetch is None
        assert it._stop.is_set()  # worker told to drop staged chunks
        # v_projection after the drop builds a fresh stream and still works
        base = PMDLoader(movie, background_rank=0, seed=0)
        np.testing.assert_array_equal(
            np.asarray(loader.v_projection(u, p)),
            np.asarray(base.v_projection(u, p)),
        )

    def test_mismatched_mode_discarded(self, rng):
        # a handle staged for mesh=None (device_put chunks) must not be fed
        # into a meshed v_projection (host chunks) — and vice versa
        movie, u, p = self._setup(rng)
        loader = PMDLoader(movie, background_rank=0, seed=0)
        assert loader.start_v_prefetch(mesh=None) is True
        it = loader._v_prefetch["iter"]
        assert loader._take_v_prefetch(False) is None
        assert it._stop.is_set()
        assert loader._v_prefetch is None

    def test_device_resident_movie_skips_prefetch(self, rng):
        movie = jnp.asarray(
            (rng.standard_normal((60, 12, 12)) + 4).astype(np.float32)
        )
        loader = PMDLoader(movie, background_rank=0, seed=0)
        assert loader.start_v_prefetch() is False


class TestDeviceMovie:
    def test_device_slicing(self, rng):
        movie = rng.standard_normal((50, 8, 6)).astype(np.float32)
        dm = as_dataset(jnp.asarray(movie))
        assert isinstance(dm, DeviceMovie)
        np.testing.assert_allclose(np.asarray(dm[3:7]), movie[3:7])
        np.testing.assert_allclose(np.asarray(dm[[1, 5, 9]]), movie[[1, 5, 9]])

    def test_list_indices_bounds_checked(self, rng):
        # jnp gather would silently clamp dm[[0, 50]] to frame 49; the
        # dataset contract (PMDDataset/PlaneView) is IndexError — device
        # residency must not change plane semantics
        movie = rng.standard_normal((50, 8, 6)).astype(np.float32)
        dm = DeviceMovie(jnp.asarray(movie))
        with pytest.raises(IndexError):
            dm[[0, 50]]
        with pytest.raises(IndexError):
            dm[np.array([-51])]
        # in-range negatives keep numpy semantics
        np.testing.assert_allclose(np.asarray(dm[[-1]]), movie[[-1]])

    def test_loader_zero_copy_pipeline(self, rng):
        movie = rng.standard_normal((400, 16, 12)).astype(np.float32) + 5
        loader = PMDLoader(jnp.asarray(movie), background_rank=1, seed=0)
        assert loader._device_resident
        np.testing.assert_allclose(loader.mean_img, movie.mean(axis=0), rtol=1e-4)

    def test_v_projection_matches_between_host_and_device_datasets(self, rng):
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        movie = (rng.standard_normal((300, 20, 20)) + 4).astype(np.float32)
        grid = BlockGrid(20, 20, (10, 10))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 3)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), 400,
            jnp.zeros((400, 1), jnp.float32),
        )
        p = rng.standard_normal((u.shape[1], 5)).astype(np.float32)

        l_host = PMDLoader(movie, background_rank=0, seed=0)
        l_dev = PMDLoader(jnp.asarray(movie), background_rank=0, seed=0)
        v_host = np.asarray(l_host.v_projection(u, jnp.asarray(p)))
        v_dev = np.asarray(l_dev.v_projection(u, jnp.asarray(p)))
        np.testing.assert_allclose(v_host, v_dev, atol=1e-3)


class _CountingDataset:
    """PMDDataset-duck-typed wrapper counting frame reads."""

    def __init__(self, movie):
        self._movie = movie
        self.reads = 0

    @property
    def dtype(self):
        return self._movie.dtype

    @property
    def shape(self):
        return self._movie.shape

    @property
    def ndim(self):
        return 3

    def __getitem__(self, item):
        self.reads += 1
        return self._movie[item]


class TestHBMMovieCache:
    def _make(self, rng, t=520, d1=14, d2=12):
        return (rng.standard_normal((t, d1, d2)) * 2 + 5).astype(np.float32)

    def test_full_cache_stops_dataset_reads(self, rng):
        movie = self._make(rng)
        counting = _CountingDataset(movie)
        loader = PMDLoader(counting, background_rank=1, seed=0, cache_movie=True)
        assert loader._cache_frames == movie.shape[0]
        reads_after_stats = counting.reads
        # everything after the stats pass is served from HBM
        loader.temporal_crop_with_filter(list(range(100, 400)))
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        grid = BlockGrid(14, 12, (7, 6))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 2)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), 14 * 12,
            jnp.asarray(loader.spatial_basis),
        )
        p = jnp.asarray(
            rng.standard_normal((u.shape[1], 3)).astype(np.float32)
        )
        loader.v_projection(u, p)
        assert counting.reads == reads_after_stats

    def test_cached_and_uncached_results_identical(self, rng):
        movie = self._make(rng)
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid

        grid = BlockGrid(14, 12, (7, 6))
        panels = rng.standard_normal(
            (grid.n_blocks, grid.pixels_per_block, 2)
        ).astype(np.float32)

        outs = {}
        for flag in (True, False):
            loader = PMDLoader(movie, background_rank=1, seed=0, cache_movie=flag)
            u = BlockSparseMatrix(
                jnp.asarray(panels), jnp.asarray(grid.rows), 14 * 12,
                jnp.asarray(loader.spatial_basis),
            )
            p = jnp.asarray(np.ones((u.shape[1], 3), np.float32))
            outs[flag] = (
                np.asarray(loader.mean_img),
                np.asarray(loader.std_img),
                np.asarray(loader.v_projection(u, p)),
            )
        for a, b in zip(outs[True], outs[False]):
            np.testing.assert_allclose(a, b, atol=1e-5)

    def test_partial_prefix_cache_serves_identical_bytes(self, rng):
        """A prefix cache (movie bigger than the budget) must split streamed
        ranges at the boundary and serve the exact same bytes."""
        movie = self._make(rng, t=700)
        loader = PMDLoader(movie, background_rank=0, seed=0, cache_movie=False)
        # install a 300-frame prefix cache by hand (the planner would build
        # one when the device reports a limited budget)
        loader._cache = jnp.asarray(movie[:300])
        loader._cache_frames = 300

        plain = PMDLoader(movie, background_rank=0, seed=0, cache_movie=False)
        got = np.concatenate(
            [np.asarray(c) for c in loader._iter_raw_chunks(256)], axis=0
        )
        want = np.concatenate(
            [np.asarray(c) for c in plain._iter_raw_chunks(256)], axis=0
        )
        np.testing.assert_allclose(got, want)
        # cache-interior, boundary-straddling, and beyond-cache requests
        np.testing.assert_allclose(
            np.asarray(loader._load_raw(slice(10, 200))), movie[10:200]
        )
        np.testing.assert_allclose(
            np.asarray(loader._load_raw(slice(250, 400))), movie[250:400]
        )
        np.testing.assert_allclose(
            np.asarray(loader._load_raw([5, 150, 299])), movie[[5, 150, 299]]
        )
        np.testing.assert_allclose(
            np.asarray(loader._load_raw([5, 150, 500])), movie[[5, 150, 500]]
        )

    def test_negative_indices_bypass_partial_cache(self, rng):
        """Negative frame indices address the movie TAIL; a prefix cache
        must not serve them — regression: cache[-5] returned frame
        n_cached-5 instead of movie frame T-5."""
        movie = self._make(rng, t=700)
        loader = PMDLoader(movie, background_rank=0, seed=0, cache_movie=False)
        loader._cache = jnp.asarray(movie[:300])
        loader._cache_frames = 300
        np.testing.assert_allclose(
            np.asarray(loader._load_raw(-5)), movie[-5][None]
        )
        np.testing.assert_allclose(
            np.asarray(loader._load_raw([-5, 10])), movie[[-5, 10]]
        )

    def test_auto_policy_without_memory_stats_is_off(self, rng):
        movie = self._make(rng)
        loader = PMDLoader(movie, background_rank=0, seed=0, cache_movie="auto")
        # CPU backend has no memory_stats -> no cache built
        assert loader._cache is None and loader._cache_frames == 0


class TestStatsPassOOMRetry:
    """The stats pass builds the HBM movie cache while it streams; a
    RESOURCE_EXHAUSTED during it must drop the cache and
    recompute the statistics without it (same numbers, bounded memory)."""

    def _make(self, rng, t=520, d1=14, d2=12):
        return (rng.standard_normal((t, d1, d2)) * 2 + 5).astype(np.float32)

    def test_stats_oom_drops_cache_and_retries(self, rng, monkeypatch):
        import localmd_tpu.loader as loader_mod

        movie = self._make(rng)
        want = PMDLoader(movie, background_rank=1, seed=0, cache_movie=False)

        real = loader_mod.get_mean_and_noise
        calls = {"n": 0}

        def flaky(chunk, t_total):
            calls["n"] += 1
            if calls["n"] == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")
            return real(chunk, t_total)

        monkeypatch.setattr(loader_mod, "get_mean_and_noise", flaky)
        loader = PMDLoader(movie, background_rank=1, seed=0, cache_movie=True)
        # the retry ran without the cache and must not rebuild it
        assert loader._cache is None and loader._cache_frames == 0
        assert loader._cache_policy is False
        assert calls["n"] >= 2
        np.testing.assert_allclose(
            np.asarray(loader.mean_img), np.asarray(want.mean_img), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(loader.std_img), np.asarray(want.std_img), atol=1e-6
        )

    def test_stats_oom_without_cache_reraises(self, rng, monkeypatch):
        import localmd_tpu.loader as loader_mod

        movie = self._make(rng)

        def dead(chunk, t_total):
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")

        monkeypatch.setattr(loader_mod, "get_mean_and_noise", dead)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            PMDLoader(movie, background_rank=1, seed=0, cache_movie=False)

    def test_non_oom_error_propagates(self, rng, monkeypatch):
        import localmd_tpu.loader as loader_mod

        movie = self._make(rng)

        def dead(chunk, t_total):
            raise ValueError("unrelated failure")

        monkeypatch.setattr(loader_mod, "get_mean_and_noise", dead)
        with pytest.raises(ValueError, match="unrelated"):
            PMDLoader(movie, background_rank=1, seed=0, cache_movie=True)
