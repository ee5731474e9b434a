"""End-to-end pipeline tests (reference test strategy, test/test_pmd.py, plus
the numerical-correctness oracles the reference lacks — SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from localmd_tpu import (
    PMDArray,
    load_decomposition,
    localmd_decomposition,
    save_decomposition,
)
from localmd_tpu.factorization import compute_lowrank_factorized_svd

from conftest import make_low_rank_movie

# End-to-end pipeline runs (20-60 s each): quick lane skips this module (pytest -m 'not slow')
pytestmark = pytest.mark.slow


class TestDecompositionEndToEnd:
    @pytest.mark.parametrize("block_size", [(16, 16), (20, 24)])
    def test_exact_low_rank_movie_reconstructs(self, rng, block_size):
        movie = make_low_rank_movie(5, (400, 40, 40), rng)
        pmd = localmd_decomposition(
            movie, block_size, frame_range=400, max_components=8,
            background_rank=3, temporal_avg_factor=4, sim_iters=60, seed=0,
        )
        recon = pmd[:, :, :]
        rel = np.linalg.norm(recon - movie) / np.linalg.norm(movie)
        assert rel < 1e-2, rel

    def test_block_size_below_minimum_raises(self, rng):
        movie = make_low_rank_movie(3, (300, 40, 40), rng)
        with pytest.raises(ValueError):
            localmd_decomposition(movie, (4, 4), frame_range=300, sim_iters=10)

    def test_degenerate_sketch_room_raises_clearly(self, rng):
        # frame_range/temporal_avg_factor so small the rSVD sketch clamp
        # drives max_components to 0: a clear ValueError, not a crash
        # deep inside the packing kernel
        movie = make_low_rank_movie(2, (300, 40, 40), rng)
        with pytest.raises(ValueError, match="no room for the rSVD sketch"):
            localmd_decomposition(
                movie, (10, 10), frame_range=100, max_components=10,
                background_rank=1, temporal_avg_factor=10, sim_iters=10,
                seed=0,
            )

    def test_tiny_fov_raises(self, rng):
        movie = make_low_rank_movie(2, (300, 8, 40), rng)
        with pytest.raises(ValueError):
            localmd_decomposition(movie, (16, 16), frame_range=300, sim_iters=10)

    def test_oversized_blocks_truncated_to_fov(self, rng):
        movie = make_low_rank_movie(3, (300, 30, 30), rng)
        pmd = localmd_decomposition(
            movie, (64, 64), frame_range=300, max_components=6,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        recon = pmd[:, :, :]
        rel = np.linalg.norm(recon - movie) / np.linalg.norm(movie)
        assert rel < 1e-2, rel

    def test_more_frames_requested_than_exist(self, rng):
        # exercises the reference's warning path (decomposition.py:681-688)
        movie = make_low_rank_movie(3, (250, 24, 24), rng)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=5000, max_components=6,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        assert pmd.shape == (250, 24, 24)

    def test_window_chunks_path(self, rng):
        movie = make_low_rank_movie(4, (400, 24, 24), rng, noise=0.01)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=400, window_chunks=100,
            max_components=8, background_rank=2, temporal_avg_factor=4,
            sim_iters=30, seed=0,
        )
        recon = pmd[:, :, :]
        rel = np.linalg.norm(recon - movie) / np.linalg.norm(movie)
        assert rel < 0.05, rel

    def test_no_background_rank(self, rng):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=300, max_components=6,
            background_rank=0, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 1e-2, rel

    def test_rank_prune(self, rng):
        movie = make_low_rank_movie(4, (400, 24, 24), rng)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=400, max_components=8, rank_prune=True,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 0.02, rel

    def test_pixel_weighting_and_denoisers(self, rng):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        w = np.ones((24, 24), dtype=np.float32)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=300, max_components=6,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
            pixel_weighting=w,
            spatial_denoiser=lambda x: x,
            temporal_denoiser=lambda x: x,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 1e-2, rel


class TestImageJStackEndToEnd:
    def test_pipeline_on_imagej_hyperstack_tiff(self, rng, tmp_path):
        """End-to-end on a 2p-style movie written the way ImageJ writes ALL
        of its large stacks: ONE IFD + 'images=N' + contiguous uint16
        frames (the demoMovie.tif blob is absent from the environment;
        this pins the same format risk with a generated fixture)."""
        from test_io_and_dataset import _craft_tiff

        t, d1, d2 = 300, 24, 24
        clean = make_low_rank_movie(3, (t, d1, d2), rng)
        movie = np.clip(clean * 2000 + 30 * rng.standard_normal(
            (t, d1, d2)), 0, 65535).astype(np.uint16)
        path = str(tmp_path / "ij2p.tif")
        _craft_tiff(path, movie, single_ifd=True,
                    description=f"ImageJ=1.54f\nimages={t}\nframes={t}\n")
        pmd = localmd_decomposition(
            path, (12, 12), frame_range=300, max_components=6,
            background_rank=1, temporal_avg_factor=4, sim_iters=20, seed=0,
        )
        assert pmd.shape == (t, d1, d2)
        recon = pmd[:, :, :]
        # reconstruction should sit at the injected noise floor, not above
        rel = np.linalg.norm(recon - movie) / np.linalg.norm(movie)
        noise_floor = np.linalg.norm(movie - np.clip(clean * 2000, 0, 65535)
                                     ) / np.linalg.norm(movie)
        assert rel < 1.5 * noise_floor + 0.02, (rel, noise_floor)


class TestPMDArraySemantics:
    @pytest.fixture(scope="class")
    def pmd(self):
        rng = np.random.default_rng(3)
        movie = make_low_rank_movie(4, (300, 30, 26), rng)
        out = localmd_decomposition(
            movie, (14, 12), frame_range=300, max_components=8,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        return out, movie

    def test_shapes_and_props(self, pmd):
        arr, movie = pmd
        assert arr.shape == movie.shape
        assert arr.ndim == 3
        assert arr.dtype == np.float32
        # UR orthonormal columns (the library prunes sub-noise-floor
        # directions via final_rank_tol, so all retained must be clean)
        ur = arr.u.toarray() @ arr.r
        np.testing.assert_allclose(ur.T @ ur, np.eye(ur.shape[1]), atol=1e-3)
        # V orthonormal rows
        np.testing.assert_allclose(
            arr.v @ arr.v.T, np.eye(arr.v.shape[0]), atol=1e-3
        )

    def test_single_frame(self, pmd):
        arr, movie = pmd
        f = arr[17]
        assert f.shape == (30, 26)
        np.testing.assert_allclose(f, movie[17], atol=0.5, rtol=0.1)

    def test_frame_and_spatial_crop(self, pmd):
        arr, movie = pmd
        sub = arr[10:20, 5:15, 3:9]
        assert sub.shape == (10, 10, 6)
        full = arr[:, :, :]
        np.testing.assert_allclose(sub, full[10:20, 5:15, 3:9], atol=1e-4)

    def test_two_element_key(self, pmd):
        # the reference's len(key)==2 path raises TypeError (latent bug,
        # reference pmdarray.py:146-148); ours must work
        arr, _ = pmd
        sub = arr[5:10, 0:8]
        assert sub.shape == (5, 8, 26)

    def test_device_reconstruct_matches_host(self, pmd):
        arr, _ = pmd
        dev = np.asarray(arr.reconstruct_frames([3, 9]))
        host = np.stack([arr[3], arr[9]])
        np.testing.assert_allclose(dev, host, atol=1e-4)

    def test_npz_roundtrip(self, pmd, tmp_path):
        arr, _ = pmd
        path = str(tmp_path / "d.npz")
        save_decomposition(path, arr)
        loaded = load_decomposition(path)
        np.testing.assert_allclose(loaded[7], arr[7], atol=1e-5)
        data = np.load(path, allow_pickle=True)
        expected_keys = {
            "fov_shape", "fov_order", "U_data", "U_indices", "U_indptr",
            "U_shape", "U_format", "R", "s", "Vt", "mean_img", "noise_var_img",
        }
        assert expected_keys <= set(data.keys())


class TestDeviceSlicing:
    """PMDArray slicing executes on-chip for pipeline-built arrays: gather
    the blocks intersecting the ROI, batched panel matmul, crop — never the
    CSR export (BASELINE north star)."""

    KEYS = [
        (5,),
        (slice(2, 9),),
        ([3, 7, 11],),
        (5, slice(3, 17), slice(4, 20)),          # interior ROI
        (slice(None), slice(None), slice(None)),  # full movie
        ([0, -1], [2, 5], [3, 7]),                # elementwise fancy pairing
        (slice(0, 10), 7),                        # 2-key (ref latent bug)
        (-1, -3, -5),                             # negative ints
        (slice(None), slice(10, 11), slice(None)),
        (np.arange(0, 300, 37), slice(0, 5), [0, 1, 2]),
    ]

    @pytest.fixture(scope="class")
    def pmd(self):
        rng = np.random.default_rng(5)
        movie = make_low_rank_movie(4, (300, 30, 26), rng)
        out = localmd_decomposition(
            movie, (14, 12), frame_range=300, max_components=8,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )
        assert out._blocksparse is not None
        return out

    def test_device_path_matches_host_and_never_builds_csr(self, pmd, monkeypatch):
        from localmd_tpu.pmd_array import PMDArray

        calls = []
        orig = PMDArray._ensure_csr

        def spy(self_):
            calls.append(1)
            return orig(self_)

        monkeypatch.setattr(PMDArray, "_ensure_csr", spy)
        dev = [pmd[k if len(k) > 1 else k[0]] for k in self.KEYS]
        assert not calls, "device slicing must never materialize the CSR"
        monkeypatch.setattr(PMDArray, "_ensure_csr", orig)

        # force the host CSR path by hiding the device factors
        bs = pmd._blocksparse
        pmd.u, pmd.r  # materialize host factors first
        pmd._blocksparse = None
        try:
            host = [pmd[k if len(k) > 1 else k[0]] for k in self.KEYS]
        finally:
            pmd._blocksparse = bs
        for k, d, h in zip(self.KEYS, dev, host):
            assert d.shape == h.shape, k
            np.testing.assert_allclose(d, h, atol=1e-4, err_msg=str(k))

    def test_error_parity(self, pmd):
        with pytest.raises(ValueError):
            pmd[None]
        with pytest.raises(ValueError):
            pmd[0, None]
        with pytest.raises(ValueError):
            pmd[0, 0, 0, 0]
        with pytest.raises(IndexError):
            pmd[0, 999, 0]

    def test_slice_device_returns_jax_array(self, pmd):
        import jax

        out = pmd.slice_device(slice(0, 3), slice(2, 8), slice(1, 9))
        assert isinstance(out, jax.Array)
        assert out.shape == (3, 6, 8)
        np.testing.assert_allclose(
            np.asarray(out), pmd[0:3, 2:8, 1:9], atol=1e-5
        )

    def test_frame_chunked_slice_matches(self, pmd, monkeypatch):
        # shrink the canvas budget so a full-movie slice takes the
        # multi-chunk path, and check the seams are invisible
        import localmd_tpu.pmd_array as pa

        full = pmd[:, 0:8, 0:6]
        monkeypatch.setattr(
            pa, "_SLICE_CANVAS_BUDGET_BYTES", 8 * 6 * 4 * 32
        )
        chunked = pmd[:, 0:8, 0:6]
        np.testing.assert_allclose(chunked, full, atol=1e-6)

    def test_empty_selection(self, pmd):
        out = pmd[[], 0:5, 0:5]
        assert out.shape == (0, 5, 5) or out.size == 0
        # slice_device must take the same guard, not crash in r.min()
        dev = pmd.slice_device([], [0, 1], [0])
        assert dev.shape[0] == 0

    def test_strided_slice_budget_uses_bbox_extent(self, pmd, monkeypatch):
        # a strided selection allocates a FULL-extent canvas however few
        # pixels it keeps; the frame-chunk budget must divide by the
        # bounding-box area, not the selected-pixel count
        ext = pmd._slice_pixel_extent(
            np.asarray(pmd.row_indices[[0, 29], :][:, [0, 25]])
        )
        assert ext == 30 * 26  # 4 pixels selected, full-FOV bounding box
        import localmd_tpu.pmd_array as pa

        full = pmd[:, ::4, ::4]
        monkeypatch.setattr(pa, "_SLICE_CANVAS_BUDGET_BYTES", 30 * 26 * 4 * 16)
        chunked = pmd[:, ::4, ::4]
        np.testing.assert_allclose(chunked, full, atol=1e-6)

    def test_slice_canvas_budget_is_device_scaled(self, monkeypatch):
        # default budget (override None) comes from transient_budget_bytes —
        # HBM-scaled like every other transient budget —
        # while a numeric override pins it for tests
        import localmd_tpu.pmd_array as pa
        import localmd_tpu.utils as u

        monkeypatch.setattr(pa, "_SLICE_CANVAS_BUDGET_BYTES", None)
        monkeypatch.setattr(u, "transient_budget_bytes", lambda: 12345)
        assert pa._slice_canvas_budget() == 12345
        monkeypatch.setattr(pa, "_SLICE_CANVAS_BUDGET_BYTES", 777)
        assert pa._slice_canvas_budget() == 777


class TestAOTWarm:
    """Background AOT warm-compile of the block-stage program (localmd_tpu.aot):
    hides program compile+load behind the streaming stats pass. Must be
    numerically invisible and fall back on any geometry
    mismatch."""

    KW = dict(
        block_sizes=(10, 10), frame_range=400, max_components=6,
        background_rank=2, temporal_avg_factor=5, sim_iters=20, seed=0,
        block_batch_size=16,
    )

    def test_aot_path_used_and_identical(self, rng):
        movie = make_low_rank_movie(4, (400, 40, 40), rng, noise=0.3)
        off = localmd_decomposition(movie, aot_warm=False, **self.KW)
        on = localmd_decomposition(movie, aot_warm=True, **self.KW)
        assert on.pipeline_aot == {"enabled": True, "used": True}
        assert off.pipeline_aot == {"enabled": False, "used": False}
        np.testing.assert_allclose(on[5], off[5], atol=1e-6)
        np.testing.assert_allclose(on.s, off.s, rtol=1e-6)

    def test_geometry_mismatch_falls_back(self, rng):
        # compile for the wrong batch size: dispatch must take the traced
        # path and still produce the right answer
        from localmd_tpu.aot import BlockProgramWarmer
        from localmd_tpu.engine import identity

        w = BlockProgramWarmer()
        w.start(
            d1=40, d2=40, t_data=400, bb=32, b1=10, b2=10, max_components=6,
            temporal_avg_factor=5, spatial_avg_factor=2,
            max_consecutive_failures=1, spatial_denoiser=identity,
            temporal_denoiser=identity, t_used=400,
        )
        statics = (10, 10, 6, 5, 2, 1, identity, identity, 400, "single", 0, 0)
        assert w.get((40, 40, 400), 16, statics) is None  # bb mismatch
        assert w.get((40, 40, 300), 32, statics) is None  # shape mismatch
        bad_t_used = statics[:8] + (390,) + statics[9:]
        assert w.get((40, 40, 400), 32, bad_t_used) is None
        assert w.get((40, 40, 400), 32, statics) is not None

    def test_multiwindow_plan_geometry(self):
        from localmd_tpu.aot import plan_block_stage

        import jax

        plan = plan_block_stage(
            shape=(1000, 40, 40), frame_range=400, window_chunks=100,
            block_sizes=(10, 10), max_components=6, temporal_avg_factor=5,
            spatial_avg_factor=2, block_batch_size=16,
            cache_target_frames=0, cache_itemsize=2,
            device_resident_bytes=0, device=jax.devices()[0],
        )
        assert plan is not None and plan["kind"] == "multi"
        # 400 init frames, window 100 -> 4 windows of the binning-rounded
        # length
        assert plan["window_length"] == 100
        assert plan["n_windows"] == 4
        assert plan["crop_avg_constant"] == 400

    def test_multiwindow_aot_used_and_identical(self, rng):
        kw = dict(
            block_sizes=(10, 10), frame_range=400, window_chunks=100,
            max_components=6, background_rank=2, temporal_avg_factor=5,
            sim_iters=20, seed=0, block_batch_size=16,
        )
        movie = make_low_rank_movie(4, (400, 40, 40), rng, noise=0.3)
        off = localmd_decomposition(movie, aot_warm=False, **kw)
        on = localmd_decomposition(movie, aot_warm=True, **kw)
        assert on.pipeline_aot == {"enabled": True, "used": True}
        np.testing.assert_allclose(on[5], off[5], atol=1e-6)
        np.testing.assert_allclose(on.s, off.s, rtol=1e-6)

    def test_stage_warms_run_and_match(self, rng):
        # the downstream-stage warmer must (a) actually fire, (b) never
        # error, (c) leave results bit-identical, and (d) predict the
        # final-reformat shapes correctly at the counts sync (a correct
        # prediction means the exact-shape re-fire after ``p`` dedupes,
        # so exactly ONE final:<k> name appears)
        movie = make_low_rank_movie(4, (400, 40, 40), rng, noise=0.3)
        off = localmd_decomposition(movie, aot_warm=False, **self.KW)
        on = localmd_decomposition(movie, aot_warm=True, **self.KW)
        assert off.pipeline_warm == {"completed": [], "errors": {}}
        assert off._stage_warmer is None
        # join the live warmer: pipeline_warm is a non-blocking snapshot,
        # so threads may still be draining at return on a fast machine
        on._stage_warmer.join_all(timeout=120)
        assert on._stage_warmer.errors == {}
        assert "thresholds" in on._stage_warmer.completed
        finals = [
            n for n in on._stage_warmer.completed if n.startswith("final:")
        ]
        # exactly ONE final:<k>, with the counts-sync prediction matching
        # the exact post-projector shape (a mismatch would leave two)
        assert finals == [f"final:{on.pipeline_ranks['reduced']}"]
        np.testing.assert_allclose(on[5], off[5], atol=1e-6)
        np.testing.assert_allclose(on.s, off.s, rtol=1e-6)

    def test_stage_warmer_swallow_and_dedup(self):
        import threading

        from localmd_tpu.aot import StageWarmer

        w = StageWarmer()
        seen = []
        evt = threading.Event()

        def boom():
            raise RuntimeError("warm failure must be swallowed")

        def ok():
            seen.append(1)
            evt.set()
            return jnp_zeros_scalar()

        def jnp_zeros_scalar():
            import jax.numpy as jnp

            return jnp.zeros(())

        w.start("boom", boom)
        w.start("ok", ok)
        w.start("ok", ok)  # dedup: must not run twice
        w.join("boom")
        w.join("ok")
        w.join("never-started")  # no-op
        assert evt.wait(5) and seen == [1]
        assert "ok" in w.completed and "boom" in w.errors
        assert "boom" not in w.completed

    def test_stage_warmer_global_registry_skips_rerun(self):
        # a name+token warmed once in the process must not re-EXECUTE its
        # dummy in later pipeline runs (the executable cache is process-
        # global; re-running the dummy burns device time on the warm path)
        from localmd_tpu.aot import StageWarmer, clear_warm_registry

        clear_warm_registry()
        try:
            runs = []

            def make(tag):
                def fn():
                    runs.append(tag)
                    import jax.numpy as jnp

                    return jnp.zeros(())

                return fn

            w1 = StageWarmer()
            w1.start("prog", make("a"), token=(32, 32))
            w1.join("prog")
            assert runs == ["a"] and "prog" in w1.completed

            w2 = StageWarmer()
            w2.start("prog", make("b"), token=(32, 32))  # registry hit
            w2.join("prog")
            assert runs == ["a"]                  # did NOT re-execute
            assert "prog" in w2.completed         # still reported warm

            w3 = StageWarmer()
            w3.start("prog", make("c"), token=(64, 64))  # different program
            w3.join("prog")
            assert runs == ["a", "c"]

            # failures must not register (the next run retries)
            def boom():
                raise RuntimeError("x")

            w4 = StageWarmer()
            w4.start("bad", boom, token=(1,))
            w4.join("bad")
            w5 = StageWarmer()
            w5.start("bad", make("d"), token=(1,))
            w5.join("bad")
            assert "d" in runs
        finally:
            clear_warm_registry()

    def test_eigh_plan_matches_dispatch_branches(self):
        from localmd_tpu.factorization import eigh_plan

        # low-rank bound well under m: randomized range capture
        assert eigh_plan(4000, 300) == ("subspace", 332)
        # k_sketch saturates at m: full eigh
        assert eigh_plan(512, 512) == ("full", 512)
        # small m never uses the sketch path
        assert eigh_plan(256, 10) == ("full", 42)
        # boundary: 4*(k+32) <= 3*m exactly
        assert eigh_plan(1024, 736)[0] == "subspace"
        assert eigh_plan(1024, 737)[0] == "full"

    def test_normalized_init_geometry(self):
        from localmd_tpu.aot import normalized_init_geometry

        # window_chunks None -> frame_range; both clamp to the movie
        assert normalized_init_geometry((1000, 40, 40), 400, None, (10, 10)) \
            == (400, 400, 10, 10)
        assert normalized_init_geometry((300, 40, 40), 400, 500, (10, 10)) \
            == (300, 300, 10, 10)
        assert normalized_init_geometry((1000, 40, 40), 400, 100, (10, 10)) \
            == (400, 100, 10, 10)
        # blocks clamp to a small FOV instead of raising
        assert normalized_init_geometry((1000, 8, 8), 400, None, (10, 10)) \
            == (400, 400, 8, 8)
        with pytest.raises(ValueError):  # sub-minimum block sizes
            normalized_init_geometry((1000, 40, 40), 400, None, (4, 10))

    def test_block_batch_budget_branches(self):
        # ONE formula shared by pipeline dispatch and the AOT planner:
        # exercise devices that report memory_stats and devices that do not
        # (empty dict, or no method at all), and the power-of-two
        # quantization
        from localmd_tpu.utils.device import block_batch_budget

        class StatsDev:
            def memory_stats(self):
                return {"bytes_limit": 16 << 30, "bytes_in_use": 2 << 30}

        class EmptyStatsDev:
            def memory_stats(self):
                return {}

        class NoStatsDev:
            pass

        kw = dict(per_block_bytes=32 * 32 * 1024 * 16, n_blocks=961,
                  block_batch_size=256)
        # memory_stats branch: 40% of (16-2) GB free / 16 MB per block
        # = 358 -> min(256, 961, 358) = 256, quantized (256 < 961) -> 256
        assert block_batch_budget(StatsDev(), **kw) == 256
        # pending_bytes shrinks the free pool the same way bytes_in_use does
        assert block_batch_budget(
            StatsDev(), **kw, pending_bytes=12 << 30
        ) == block_batch_budget(
            type("D", (), {"memory_stats": lambda s: {
                "bytes_limit": 16 << 30, "bytes_in_use": 14 << 30}})(),
            **kw,
        )
        # no memory statistics: the 1 GB floor, 1e9 // 16 MB = 59 -> 32
        floor = block_batch_budget(EmptyStatsDev(), **kw)
        assert floor == block_batch_budget(NoStatsDev(), **kw) == 32
        assert floor < block_batch_budget(StatsDev(), **kw)
        # power-of-two quantization below n_blocks
        assert floor & (floor - 1) == 0
        # bb == n_blocks is NOT quantized (one chunk, no padding)
        assert block_batch_budget(
            StatsDev(), per_block_bytes=1024, n_blocks=961,
            block_batch_size=2000,
        ) == 961

    def test_planner_and_pipeline_share_budget_formula(self, monkeypatch):
        # the AOT plan's bb and the dispatch bb must come from the SAME
        # function — spy it from both entry points
        import localmd_tpu.utils.device as udev
        from localmd_tpu.aot import plan_block_stage

        import jax

        calls = []
        orig = udev.block_batch_budget

        def spy(*a, **k):
            out = orig(*a, **k)
            calls.append(out)
            return out

        monkeypatch.setattr(udev, "block_batch_budget", spy)
        plan = plan_block_stage(
            shape=(3000, 256, 256), frame_range=1024, window_chunks=None,
            block_sizes=(32, 32), max_components=20, temporal_avg_factor=10,
            spatial_avg_factor=2, block_batch_size=256,
            cache_target_frames=0, cache_itemsize=4,
            device_resident_bytes=0, device=jax.devices()[0],
        )
        assert calls and plan["bb"] == calls[-1]

    def test_plan_matches_pipeline_clamps(self):
        # the planner mirrors the pipeline's deterministic max_components /
        # t_init clamp chain; a drift here only wastes a compile, but keep
        # the mirror honest
        from localmd_tpu.aot import plan_block_stage

        import jax

        plan = plan_block_stage(
            shape=(30000, 512, 512), frame_range=4096, window_chunks=None,
            block_sizes=(32, 32), max_components=20, temporal_avg_factor=10,
            spatial_avg_factor=2, block_batch_size=256,
            cache_target_frames=11264, cache_itemsize=2,
            device_resident_bytes=0, device=jax.devices()[0],
        )
        assert plan is not None
        assert plan["t_data"] == 4096
        assert plan["crop_avg_constant"] == 4090
        assert plan["max_components"] == 20
        assert plan["b1"] == plan["b2"] == 32


class TestFactorizedSVD:
    def test_scipy_sparse_input_matches_dense_svd(self, rng):
        # public API accepts reference-style scipy matrices
        d, r, t = 200, 12, 90
        u = scipy.sparse.random(d, r, density=0.3, random_state=1, dtype=np.float64)
        v = rng.standard_normal((r, t)).astype(np.float32)
        p, s, vt = compute_lowrank_factorized_svd(u, jnp.asarray(v))
        product = u.toarray() @ v
        s_np = np.linalg.svd(product, compute_uv=False)
        np.testing.assert_allclose(
            np.asarray(s)[: len(s_np)], s_np[: len(np.asarray(s))], rtol=2e-2, atol=1e-2
        )
        recon = (u.toarray() @ np.asarray(p)) * np.asarray(s)[None, :] @ np.asarray(vt)
        np.testing.assert_allclose(recon, product, atol=1e-2)

    def test_only_left_gives_orthonormal_up(self, rng):
        d, r, t = 150, 10, 80
        u = scipy.sparse.random(d, r, density=0.4, random_state=2)
        v = rng.standard_normal((r, t)).astype(np.float32)
        p = compute_lowrank_factorized_svd(u, jnp.asarray(v), only_left=True)
        up = u.toarray() @ np.asarray(p)
        np.testing.assert_allclose(up.T @ up, np.eye(up.shape[1]), atol=1e-3)

    def test_expected_rank_subspace_path_matches_full_eigh(self, rng):
        # Long-T regime: r_cols > t makes the Gram quadratic (t, t); with an
        # expected_rank well under t, the randomized subspace route replaces
        # the full eigh (4*k_sketch <= 3*m and m >= 512). The resulting UP
        # must span the same space: orthonormal columns and identical
        # reconstruction of U V.
        d, r, t, true_rank = 900, 70, 640, 24
        base = rng.standard_normal((d, true_rank)).astype(np.float32)
        mix = rng.standard_normal((true_rank, r)).astype(np.float32)
        u = scipy.sparse.csr_matrix((base @ mix) * (rng.random((d, r)) < 0.4))
        v = rng.standard_normal((r, t)).astype(np.float32)
        k = 128  # generous rank bound; k_sketch=160, m=640 -> subspace path
        assert 4 * (k + 32) <= 3 * t and t >= 512
        p_sub = compute_lowrank_factorized_svd(
            u, jnp.asarray(v), only_left=True, expected_rank=k
        )
        # force the full-eigh route by disabling the size gate via small m:
        # compare against the host-path (no expected_rank) result instead.
        p_full = compute_lowrank_factorized_svd(u, jnp.asarray(v), only_left=True)
        up_s = u.toarray() @ np.asarray(p_sub)
        up_f = u.toarray() @ np.asarray(p_full)
        # non-null columns of UP are orthonormal (zeroed directions excluded)
        live = np.linalg.norm(up_s, axis=0) > 0.5
        q = up_s[:, live]
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=2e-3)
        # both span the same subspace: projecting one basis onto the other
        # preserves norms
        proj = q @ (q.T @ up_f)
        np.testing.assert_allclose(proj, up_f, atol=2e-3)
        assert live.sum() == np.linalg.matrix_rank(
            u.toarray().astype(np.float64), tol=1e-4
        )


class TestCheckpointResume:
    def test_resume_skips_stages_and_matches(self, rng, tmp_path):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        kw = dict(
            block_sizes=(12, 12), frame_range=300, max_components=6,
            background_rank=2, temporal_avg_factor=4, sim_iters=20, seed=0,
            checkpoint_path=str(tmp_path / "ck"),
        )
        first = localmd_decomposition(movie, **kw)
        # all stage files exist
        import os
        stages = ["stats", "background", "thresholds", "blocks", "projector", "v"]
        for st in stages:
            assert os.path.exists(str(tmp_path / f"ck.{st}.npz")), st
        # rerun resumes and produces the identical factorization
        second = localmd_decomposition(movie, **kw)
        np.testing.assert_allclose(second.s, first.s, rtol=1e-5)
        np.testing.assert_allclose(second[7], first[7], atol=1e-4)

    def test_kill_mid_block_stage_resumes_per_batch(self, rng, tmp_path, monkeypatch):
        """A preemption mid-block-stage must not lose the finished batches:
        every completed batch is persisted under the fingerprint, and the
        rerun recomputes ONLY the missing blocks, yielding a bit-identical
        PMDArray (keys are pre-split per global block id)."""
        import os

        import localmd_tpu.engine as engine_mod
        from localmd_tpu import pipeline as pipeline_mod

        # 40x40 FOV / 10x10 blocks = 49 blocks -> multiple 16-block batches
        movie = make_low_rank_movie(2, (280, 40, 40), rng)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
            block_batch_size=16,
        )
        clean = localmd_decomposition(movie, **kw)

        path = str(tmp_path / "ck")
        real_step = engine_mod.window0_chunk_step
        calls = {"n": 0}

        def dying_step(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:  # first batch completes, then "preemption"
                raise KeyboardInterrupt("simulated preemption")
            return real_step(*args, **kwargs)

        monkeypatch.setattr(pipeline_mod.engine, "window0_chunk_step", dying_step)
        with pytest.raises(KeyboardInterrupt):
            localmd_decomposition(movie, checkpoint_path=path, **kw)
        parts = [f for f in os.listdir(tmp_path) if ".blocks.part" in f]
        assert len(parts) == 1, parts  # the finished batch was persisted

        monkeypatch.setattr(pipeline_mod.engine, "window0_chunk_step", real_step)
        batch_sizes_seen = []
        real_step2 = engine_mod.window0_chunk_step

        def counting_step(data, starts, *args, **kwargs):
            batch_sizes_seen.append(int(starts.shape[0]))
            return real_step2(data, starts, *args, **kwargs)

        monkeypatch.setattr(pipeline_mod.engine, "window0_chunk_step", counting_step)
        resumed = localmd_decomposition(movie, checkpoint_path=path, **kw)
        # 49 blocks, 16 done before the kill: resume dispatches only the 33
        # missing (3 batches of <=16), not the full 49 (4 batches)
        assert len(batch_sizes_seen) == 3, batch_sizes_seen
        np.testing.assert_allclose(resumed[5], clean[5], atol=1e-5)
        np.testing.assert_allclose(resumed.s, clean.s, rtol=1e-5)
        # the whole-stage checkpoint supersedes the parts, which are cleaned up
        assert not [f for f in os.listdir(tmp_path) if ".blocks.part" in f]
        assert os.path.exists(path + ".blocks.npz")

    def test_config_change_invalidates(self, rng, tmp_path):
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "ck")
        localmd_decomposition(movie, checkpoint_path=path, **kw)
        # different max_components -> stale checkpoints must be ignored
        kw2 = dict(kw, max_components=5)
        out = localmd_decomposition(movie, checkpoint_path=path, **kw2)
        assert out.shape == (280, 20, 20)

    def test_pixel_weighting_and_denoiser_invalidate(self, rng, tmp_path):
        """Changing pixel_weighting or a denoiser must invalidate the resume
        fingerprint — otherwise a rerun silently reuses 'blocks' computed with
        the old settings."""
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "ck")
        base = localmd_decomposition(movie, checkpoint_path=path, **kw)

        weighting = np.ones((20, 20), dtype=np.float32)
        weighting[:10] = 2.0
        weighted = localmd_decomposition(
            movie, checkpoint_path=path, pixel_weighting=weighting, **kw
        )
        # the weighted run must NOT have resumed the unweighted blocks: its
        # U differs (weighting scales the spatial components pre-assembly)
        assert not np.allclose(
            np.asarray(weighted.u.todense()), np.asarray(base.u.todense())
        )

        def scale_denoiser(x):
            return x * 0.5

        denoised = localmd_decomposition(
            movie, checkpoint_path=path, temporal_denoiser=scale_denoiser, **kw
        )
        assert denoised.shape == (280, 20, 20)
        # same weighting hash resumes cleanly (no recompute crash, same result)
        again = localmd_decomposition(
            movie, checkpoint_path=path, pixel_weighting=weighting, **kw
        )
        assert again.shape == (280, 20, 20)

    def test_denoiser_constant_change_invalidates(self, rng, tmp_path):
        """Editing only a CONSTANT in a denoiser (identical bytecode and
        name) must invalidate the resume fingerprint — co_consts is part of
        the hashed payload."""
        import jax.numpy as jnp

        movie = make_low_rank_movie(2, (280, 20, 20), rng, noise=0.2)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "ck")

        def den_a(x):
            return jnp.clip(x, -100.0, 100.0)   # ~identity

        def den_b(x):
            return jnp.clip(x, -0.01, 0.01)     # heavy distortion

        # same name + bytecode, different co_consts only
        den_b.__qualname__ = den_a.__qualname__
        assert den_a.__code__.co_code == den_b.__code__.co_code

        first = localmd_decomposition(
            movie, checkpoint_path=path, temporal_denoiser=den_a, **kw
        )
        resumed_b = localmd_decomposition(
            movie, checkpoint_path=path, temporal_denoiser=den_b, **kw
        )
        fresh_b = localmd_decomposition(movie, temporal_denoiser=den_b, **kw)
        # must have recomputed with den_b, not silently reused den_a blocks
        np.testing.assert_allclose(resumed_b[7], fresh_b[7], atol=1e-5)
        assert not np.allclose(resumed_b[7], first[7], atol=1e-3)

    def test_closure_cell_change_invalidates(self, rng, tmp_path):
        """A denoiser built by a factory (constant captured in a closure
        cell) must also invalidate on a cell-value change."""
        import jax.numpy as jnp

        movie = make_low_rank_movie(2, (280, 20, 20), rng, noise=0.2)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "ck")

        def make_clip(c):
            def den(x):
                return jnp.clip(x, -c, c)
            return den

        first = localmd_decomposition(
            movie, checkpoint_path=path, temporal_denoiser=make_clip(100.0), **kw
        )
        resumed = localmd_decomposition(
            movie, checkpoint_path=path, temporal_denoiser=make_clip(0.01), **kw
        )
        fresh = localmd_decomposition(
            movie, temporal_denoiser=make_clip(0.01), **kw
        )
        np.testing.assert_allclose(resumed[7], fresh[7], atol=1e-5)
        assert not np.allclose(resumed[7], first[7], atol=1e-3)


class TestOrderC:
    def test_order_c_matches_order_f(self, rng):
        """order='C' (reference decomposition.py:659 accepts it throughout)
        must produce the same reconstruction as order='F': the pixel-id
        convention is a permutation, not a different factorization."""
        movie = make_low_rank_movie(3, (300, 26, 22), rng)
        kw = dict(
            block_sizes=(12, 10), frame_range=300, max_components=5,
            background_rank=2, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        f = localmd_decomposition(movie, **kw)
        c = localmd_decomposition(movie, order="C", **kw)
        assert c.order == "C"
        np.testing.assert_allclose(c[:, :, :], f[:, :, :], atol=1e-4)
        # device reconstruct + npz roundtrip preserve the C convention
        np.testing.assert_allclose(
            np.asarray(c.reconstruct_frames([5]))[0], c[5], atol=1e-4
        )
        import tempfile, os

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "c.npz")
            c.to_npz(path)
            back = c.from_npz(path)
            assert back.order == "C"
            np.testing.assert_allclose(back[7], c[7], atol=1e-5)

    def test_order_c_with_mesh(self, rng):
        from localmd_tpu.parallel.mesh import make_mesh

        movie = make_low_rank_movie(2, (280, 24, 24), rng)
        kw = dict(
            block_sizes=(12, 12), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        single = localmd_decomposition(movie, order="C", **kw)
        sharded = localmd_decomposition(movie, order="C", mesh=make_mesh(), **kw)
        np.testing.assert_allclose(sharded[:, :, :], single[:, :, :], atol=1e-4)


class TestExportTiff:
    def test_export_denoised_movie(self, rng, tmp_path):
        """Streaming TIFF export of the reconstruction: chunked writes match
        the full reconstruction, uint16 output clips to range."""
        from localmd_tpu.io.tiff import TiffReader

        movie = make_low_rank_movie(3, (300, 22, 18), rng)
        pmd = localmd_decomposition(
            movie, (11, 10), frame_range=300, max_components=5,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "denoised.tif")
        pmd.export_tiff(path, chunk_frames=64)  # multiple chunks
        reader = TiffReader(path)
        assert len(reader) == 300
        got = reader.read_frames([0, 150, 299])
        want = np.asarray(pmd.reconstruct_frames([0, 150, 299]))
        np.testing.assert_allclose(got, want, atol=1e-4)

        path16 = str(tmp_path / "denoised16.tif")
        pmd.export_tiff(path16, frames=range(10), dtype="uint16")
        r16 = TiffReader(path16)
        assert r16.dtype == np.uint16 and len(r16) == 10


class TestBackToBackRuns:
    def test_two_runs_one_process_with_close(self, rng):
        """A library user looping over movies in one process: close() frees
        the first result's device buffers, slicing still works afterwards
        (host factors are materialized on close), and the second run
        completes (the device-resident OOM scenario, at test scale)."""
        import gc

        movie1 = make_low_rank_movie(3, (300, 24, 24), rng)
        movie2 = make_low_rank_movie(2, (280, 20, 20), rng)
        kw = dict(max_components=5, background_rank=1, temporal_avg_factor=4,
                  sim_iters=15, seed=0)
        pmd1 = localmd_decomposition(movie1, (12, 12), frame_range=300, **kw)
        before = pmd1[5]
        with pmd1:
            pass  # context manager exit calls close()
        np.testing.assert_allclose(pmd1[5], before, atol=1e-6)  # host path OK
        assert pmd1._blocksparse is None
        # device reconstruct falls back to the host CSR path after close
        np.testing.assert_allclose(
            np.asarray(pmd1.reconstruct_frames([5]))[0], before, atol=1e-4
        )
        del pmd1
        gc.collect()
        pmd2 = localmd_decomposition(movie2, (10, 10), frame_range=280, **kw)
        assert pmd2.shape == (280, 20, 20)


class TestCloseWithoutMaterialize:
    def test_close_materialize_false_drops_without_transfer(self, rng):
        """close(materialize=False) must release device buffers WITHOUT
        pulling factors to host (a multi-GB device->host copy); the array is
        then unusable and says so."""
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        assert pmd._v_host is None  # nothing materialized yet
        pmd.close(materialize=False)
        # no host copies were created by close — the D2H pull did not happen
        assert pmd._v_host is None
        assert pmd._u_csr is None
        assert pmd._blocksparse is None and pmd._v_src is None
        for prop in ("u", "v", "r"):
            with pytest.raises(RuntimeError, match="materialize=False"):
                getattr(pmd, prop)
        # s was already host numpy (pulled for pruning), so it survives a
        # transfer-free close — rank stays queryable
        assert pmd.rank == int(pmd.s.shape[0])
        # close() is idempotent: a later plain close (e.g. the context
        # manager's __exit__) must not try to materialize dropped factors
        pmd.close()
        pmd.close(materialize=False)

    def test_context_manager_exit_after_materialize_false(self, rng):
        """`with` + close(materialize=False) inside the block: __exit__'s
        close() must be a no-op, not a RuntimeError."""
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        with localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        ) as pmd:
            pmd.close(materialize=False)
        with pytest.raises(RuntimeError, match="materialize=False"):
            _ = pmd.v  # device-sourced factor is gone, without a D2H pull

    def test_close_materialize_false_keeps_existing_host_state(self, rng):
        """Factors already materialized before close survive it."""
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        before = pmd[5]
        _ = pmd.u, pmd.r, pmd.v  # materialize host factors
        pmd.close(materialize=False)
        np.testing.assert_allclose(pmd[5], before, atol=1e-6)

    def test_close_materialize_false_keeps_numpy_sources(self, rng, tmp_path):
        """npz/scipy-built arrays hold HOST factors; close(materialize=False)
        skips D2H transfers but must not discard sources that never lived on
        device — slicing keeps working."""
        from localmd_tpu import PMDArray
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "d.npz")
        pmd.to_npz(path)
        before = pmd[5]
        pmd.close()

        loaded = PMDArray.from_npz(path)
        assert loaded._v_host is None  # nothing materialized yet
        loaded.close(materialize=False)
        # numpy-backed factors survive: rank/s/slicing all still work
        assert loaded.rank == pmd.rank
        np.testing.assert_allclose(loaded[5], before, atol=1e-5)


class TestBlockStageOOMRetry:
    def test_block_stage_retries_on_resource_exhausted(self, rng, monkeypatch):
        """A RESOURCE_EXHAUSTED mid-block-stage (free device memory shrinks
        between the budget probe and execution) must halve the batch
        and redo the stage, not kill the pipeline. Keys are pre-split per
        block, so the retried run is bit-identical to an undisturbed one."""
        import localmd_tpu.engine as engine_mod
        from localmd_tpu import pipeline as pipeline_mod

        # 40x40 FOV / 10x10 blocks = 49 blocks, so the initial batch (49)
        # is above the 16-block retry floor and the halving path is real
        movie = make_low_rank_movie(2, (280, 40, 40), rng)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        clean = localmd_decomposition(movie, **kw)
        real_step = engine_mod.window0_chunk_step
        calls = {"n": 0}

        def flaky_step(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")
            return real_step(*args, **kwargs)

        monkeypatch.setattr(pipeline_mod.engine, "window0_chunk_step", flaky_step)
        retried = localmd_decomposition(movie, **kw)
        assert calls["n"] >= 2  # the stage actually re-ran
        np.testing.assert_allclose(retried[5], clean[5], atol=1e-5)

    def test_mesh_retry_keeps_batch_shardable(self, rng, monkeypatch):
        """On the mesh path the halved retry batch must stay divisible by the
        mesh size (shard_map contract) — and the retry floor becomes one
        mesh row rather than 16."""
        import jax
        from jax.sharding import Mesh

        from localmd_tpu.parallel import sharded as sharded_mod

        mesh = Mesh(np.array(jax.devices()[:4]), ("blocks",))
        movie = make_low_rank_movie(2, (280, 40, 40), rng)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        clean = localmd_decomposition(movie, **kw)

        real_step = sharded_mod.sharded_window0_chunk_step
        seen_batches = []

        def flaky_step(mesh_arg, data, starts, keys, *args, **kwargs):
            seen_batches.append(int(starts.shape[0]))
            if len(seen_batches) == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")
            return real_step(mesh_arg, data, starts, keys, *args, **kwargs)

        # the pipeline imports this symbol at call time, so patching the
        # module attribute intercepts the sharded dispatch
        monkeypatch.setattr(
            sharded_mod, "sharded_window0_chunk_step", flaky_step
        )
        retried = localmd_decomposition(movie, mesh=mesh, **kw)
        assert len(seen_batches) >= 2
        # every dispatched batch (incl. after the halving) is mesh-divisible
        assert all(b % 4 == 0 for b in seen_batches)
        assert seen_batches[-1] < seen_batches[0]  # the halving happened
        np.testing.assert_allclose(retried[5], clean[5], atol=1e-4)


class TestVPhaseOOMRetry:
    def test_v_regression_oom_drops_cache_and_retries(self, rng, monkeypatch):
        """A RESOURCE_EXHAUSTED in the V-regression/reformat phase (surfaces
        at the first device sync because the regression dispatches async)
        must drop the HBM movie cache and re-stream — same result, bounded
        memory, no dead run."""
        from localmd_tpu.loader import PMDLoader

        movie = make_low_rank_movie(2, (300, 24, 24), rng, noise=0.1)
        kw = dict(
            block_sizes=(12, 12), frame_range=300, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        clean = localmd_decomposition(movie, cache_movie=True, **kw)

        real_vproj = PMDLoader.v_projection
        calls = {"n": 0}

        def flaky_vproj(self, u, p, mesh=None):
            calls["n"] += 1
            if calls["n"] == 1:
                assert self._cache is not None  # cache held when the OOM hits
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")
            assert self._cache is None  # retry runs with the cache released
            return real_vproj(self, u, p, mesh=mesh)

        monkeypatch.setattr(PMDLoader, "v_projection", flaky_vproj)
        retried = localmd_decomposition(movie, cache_movie=True, **kw)
        assert calls["n"] == 2
        np.testing.assert_allclose(retried[5], clean[5], atol=1e-5)

    def test_v_regression_oom_without_cache_reraises(self, rng, monkeypatch):
        """With no cache to release there is nothing to retry with — the
        error must propagate (it is a genuine capacity failure)."""
        from localmd_tpu.loader import PMDLoader

        movie = make_low_rank_movie(2, (300, 24, 24), rng, noise=0.1)

        def dead_vproj(self, u, p, mesh=None):
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake neighbor burst")

        monkeypatch.setattr(PMDLoader, "v_projection", dead_vproj)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            localmd_decomposition(
                movie, (12, 12), frame_range=300, max_components=4,
                background_rank=1, temporal_avg_factor=4, sim_iters=15,
                seed=0, cache_movie=False,
            )


class TestHBMCachePipeline:
    def test_cache_movie_end_to_end_identical(self, rng):
        """cache_movie=True must be numerically invisible: the cached bytes
        are the same native-dtype frames the passes would have re-streamed."""
        movie = make_low_rank_movie(3, (300, 24, 24), rng, noise=0.1)
        kw = dict(
            block_sizes=(12, 12), frame_range=300, max_components=5,
            background_rank=2, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        cached = localmd_decomposition(movie, cache_movie=True, **kw)
        plain = localmd_decomposition(movie, cache_movie=False, **kw)
        np.testing.assert_allclose(cached.s, plain.s, rtol=1e-5)
        np.testing.assert_allclose(cached[7], plain[7], atol=1e-5)


class TestCloseScipyBuilt:
    def test_close_keeps_npz_loaded_arrays_usable(self, rng, tmp_path):
        """Default close() on a scipy/npz-built PMDArray (no device factors)
        must keep slicing working — regression: it used to drop the V source
        because the materialize step was gated on the blocksparse path."""
        from localmd_tpu import load_decomposition

        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "d.npz")
        pmd.to_npz(path)
        loaded = load_decomposition(path)
        before = loaded[5]
        loaded.close()          # materialize=True default
        np.testing.assert_allclose(loaded[5], before, atol=1e-6)


class TestFingerprintValueTokens:
    def test_large_array_closure_change_invalidates(self, rng, tmp_path):
        """A denoiser capturing a LARGE array must invalidate the resume
        fingerprint when only a middle element changes — regression: repr()
        truncation made all big arrays hash identically."""
        movie = make_low_rank_movie(2, (280, 20, 20), rng, noise=0.2)
        kw = dict(
            block_sizes=(10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        path = str(tmp_path / "ck")

        def make_weighting_denoiser(w):
            def den(x):
                return x * jnp.asarray(w, dtype=x.dtype)[None, :]
            return den

        w1 = np.ones(280, dtype=np.float32)         # full init-window length
        w2 = w1.copy()
        w2[140] = 25.0                               # middle element only
        first = localmd_decomposition(
            movie, checkpoint_path=path,
            temporal_denoiser=make_weighting_denoiser(w1), **kw
        )
        resumed = localmd_decomposition(
            movie, checkpoint_path=path,
            temporal_denoiser=make_weighting_denoiser(w2), **kw
        )
        fresh = localmd_decomposition(
            movie, temporal_denoiser=make_weighting_denoiser(w2), **kw
        )
        np.testing.assert_allclose(resumed[7], fresh[7], atol=1e-5)
        assert not np.allclose(resumed[7], first[7], atol=1e-3)

    def test_fn_token_numpy_scalar_and_defaults(self):
        """Unit-level fingerprint coverage: a captured numpy SCALAR value
        change and a default-argument value change must both produce a
        different token (regression: np.generic and __defaults__ hashed by
        type identity only -> silently stale resumes)."""
        from localmd_tpu.pipeline import _fn_token

        def make(c):
            def den(x):
                return x * c
            return den

        t1 = _fn_token(make(np.float32(0.5)))
        t2 = _fn_token(make(np.float32(0.7)))
        assert t1 != t2
        # Python float captures keep working too
        assert _fn_token(make(0.5)) != _fn_token(make(0.7))

        def den_d1(x, scale=np.float32(0.5)):
            return x * scale

        def den_d2(x, scale=np.float32(0.7)):
            return x * scale

        den_d2.__qualname__ = den_d1.__qualname__
        assert den_d1.__code__.co_code == den_d2.__code__.co_code
        assert _fn_token(den_d1) != _fn_token(den_d2)


class TestSeededReproducibility:
    def test_block_batch_size_does_not_change_results(self, rng):
        """Block sketches are keyed per GLOBAL block, not per batch: the
        same seed must give identical factors whatever the chunking (the
        batch size is derived from free device memory at runtime, so this
        is what makes seeded runs reproducible at all)."""
        movie = make_low_rank_movie(3, (300, 40, 40), rng, noise=0.1)
        kw = dict(
            block_sizes=(10, 10), frame_range=300, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        one_chunk = localmd_decomposition(movie, **kw, block_batch_size=256)
        chunked = localmd_decomposition(movie, **kw, block_batch_size=16)
        np.testing.assert_allclose(chunked.s, one_chunk.s, rtol=1e-5)
        np.testing.assert_allclose(chunked[7], one_chunk[7], atol=1e-5)

    def test_block_batch_size_invariance_multiwindow(self, rng):
        movie = make_low_rank_movie(3, (300, 40, 40), rng, noise=0.1)
        kw = dict(
            block_sizes=(10, 10), frame_range=300, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
            window_chunks=100,
        )
        one_chunk = localmd_decomposition(movie, **kw, block_batch_size=256)
        chunked = localmd_decomposition(movie, **kw, block_batch_size=16)
        np.testing.assert_allclose(chunked.s, one_chunk.s, rtol=1e-5)
        np.testing.assert_allclose(chunked[7], one_chunk[7], atol=1e-5)


class TestParameterRobustness:
    @pytest.mark.parametrize("combo", [
        # cross-feature combos a user can plausibly stack (fuzz-derived)
        dict(order="C", welch_compat="reference", cache_movie=True,
             spatial_avg_factor=3, dtype_in=np.uint16),
        dict(rank_prune=True, window_chunks=130, cache_movie=True,
             background_rank=0, dtype_in=np.float32),
        dict(order="C", rank_prune=True, welch_compat="reference",
             temporal_avg_factor=3, dtype_in=np.uint16),
    ])
    def test_feature_combinations(self, rng, combo):
        combo = dict(combo)  # parametrize dicts are shared across re-runs
        dtype_in = combo.pop("dtype_in")
        movie = (rng.random((300, 26, 23)) * 50 + 10).astype(dtype_in)
        pmd = localmd_decomposition(
            movie, (12, 11), frame_range=300, max_components=4,
            temporal_avg_factor=combo.pop("temporal_avg_factor", 4),
            background_rank=combo.pop("background_rank", 1),
            sim_iters=12, seed=0, **combo,
        )
        recon = pmd[:, :, :]
        assert recon.shape == movie.shape
        assert np.isfinite(recon).all()
        pmd.close()

    def test_odd_fov_and_block_sizes(self, rng):
        movie = make_low_rank_movie(3, (290, 37, 29), rng)
        pmd = localmd_decomposition(
            movie, (13, 11), frame_range=290, max_components=5,
            background_rank=1, temporal_avg_factor=5, sim_iters=15, seed=0,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 0.02, rel

    def test_no_spatial_averaging(self, rng):
        movie = make_low_rank_movie(2, (280, 24, 24), rng)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, spatial_avg_factor=1,
            sim_iters=15, seed=0,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 0.02, rel

    def test_small_temporal_avg(self, rng):
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=2, sim_iters=15, seed=0,
        )
        assert pmd.shape == (280, 20, 20)

    def test_invalid_order_rejected(self, rng):
        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        with pytest.raises(ValueError, match="order"):
            localmd_decomposition(
                movie, (10, 10), frame_range=280, order="K", sim_iters=5,
            )

    def test_max_consecutive_failures_two(self, rng):
        movie = make_low_rank_movie(3, (280, 20, 20), rng, noise=0.05)
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=6,
            background_rank=1, temporal_avg_factor=4,
            max_consecutive_failures=2, sim_iters=15, seed=0,
        )
        assert pmd.rank >= 1


class TestMetrics:
    def test_metrics_on_clean_movie(self, rng):
        from localmd_tpu.metrics import (
            compression_ratio,
            reconstruction_error,
            residual_noise_ratio,
        )

        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        noisy = movie + 0.3 * rng.standard_normal(movie.shape).astype(np.float32)
        pmd = localmd_decomposition(
            noisy, (12, 12), frame_range=300, max_components=6,
            background_rank=1, temporal_avg_factor=4, sim_iters=20, seed=0,
        )
        cr = compression_ratio(pmd)
        assert cr > 2, cr  # low-rank movie compresses well
        err = reconstruction_error(pmd, noisy, chunk_frames=128)
        assert 0 < err["rel_error"] < 1
        assert err["frames"] == 300
        # residual should be roughly noise-sized
        rnr = residual_noise_ratio(pmd, noisy, chunk_frames=128)
        assert 0.3 < rnr < 3.0, rnr


class TestCheckpointWithMesh:
    def test_resume_with_mesh_skips_block_stage(self, rng, tmp_path):
        from localmd_tpu.parallel.mesh import make_mesh

        movie = make_low_rank_movie(2, (280, 24, 24), rng)
        mesh = make_mesh()
        kw = dict(
            block_sizes=(12, 12), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
            mesh=mesh, checkpoint_path=str(tmp_path / "ck"),
        )
        first = localmd_decomposition(movie, **kw)
        second = localmd_decomposition(movie, **kw)
        np.testing.assert_allclose(second.s, first.s, rtol=1e-5)


class TestProfiling:
    def test_profile_dir_produces_trace(self, rng, tmp_path):
        import os

        movie = make_low_rank_movie(2, (280, 20, 20), rng)
        prof = str(tmp_path / "trace")
        pmd = localmd_decomposition(
            movie, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=10, seed=0,
            profile_dir=prof,
        )
        assert pmd.rank >= 1
        # a plugins/profile/<ts>/ directory with trace artifacts must exist
        found = []
        for root, dirs, files in os.walk(prof):
            found.extend(files)
        assert found, "no profiler artifacts written"


class TestDenoisersAndWeighting:
    def test_real_denoisers_are_applied(self, rng):
        import jax.numpy as jnp

        movie = make_low_rank_movie(3, (300, 24, 24), rng, noise=0.02)

        def temporal_denoiser(traces):  # (r, t) light smoothing
            return (traces + jnp.roll(traces, 1, axis=-1)
                    + jnp.roll(traces, -1, axis=-1)) / 3.0

        def spatial_denoiser(frames):  # (r, b1, b2) light smoothing
            return (frames + jnp.roll(frames, 1, 1) + jnp.roll(frames, -1, 1)) / 3.0

        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=300, max_components=6,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
            spatial_denoiser=spatial_denoiser, temporal_denoiser=temporal_denoiser,
        )
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 0.05, rel

    def test_nonuniform_pixel_weighting(self, rng):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        w = (0.5 + rng.random((24, 24))).astype(np.float32)
        pmd = localmd_decomposition(
            movie, (12, 12), frame_range=300, max_components=6,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
            pixel_weighting=w,
        )
        # weighting shapes the basis fit only; reconstruction is unweighted
        rel = np.linalg.norm(pmd[:, :, :] - movie) / np.linalg.norm(movie)
        assert rel < 0.05, rel


class TestDeviceOOMRetry:
    """The hardware RESOURCE_EXHAUSTED retry scopes in the pipeline, simulated
    on CPU by raising the same error text from inside each scope. On a device
    they fire when another process takes device memory mid-run; the retries
    drop the HBM movie cache and recompute — same seed, same sketches,
    identical output."""

    def _arm_fake_cache(self, monkeypatch, released):
        """Install a PMDLoader subclass whose cache is 'present' (making the
        pipeline's retry scopes eligible) but never serves a frame."""
        import localmd_tpu.pipeline as pl

        real_loader = pl.PMDLoader

        class CachedLoader(real_loader):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self._cache = jnp.zeros((1,), dtype=jnp.float32)
                self._cache_frames = 0  # inert: _cache_serves stays False

            def release_cache(self):
                released.append(True)
                super().release_cache()

        monkeypatch.setattr(pl, "PMDLoader", CachedLoader)
        return CachedLoader

    def _run(self, rng_movie):
        return localmd_decomposition(
            rng_movie, (12, 12), frame_range=300, max_components=6,
            background_rank=2, temporal_avg_factor=4, sim_iters=30, seed=0,
        )

    def test_projector_oom_recomputes_and_completes(self, rng, monkeypatch):
        import localmd_tpu.pipeline as pl

        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        clean = np.asarray(self._run(movie)[:, :, :])

        released = []
        self._arm_fake_cache(monkeypatch, released)
        real = pl.compute_lowrank_factorized_svd
        calls = []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake device OOM")
            return real(*a, **k)

        monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", flaky)
        pmd = self._run(movie)
        assert len(calls) == 2, "projector must be recomputed after the OOM"
        assert released, "the HBM movie cache must be dropped before the retry"
        # same PRNG key on the retry => bit-identical factorization
        np.testing.assert_allclose(np.asarray(pmd[:, :, :]), clean, atol=1e-5)

    def test_v_regression_oom_retries_once(self, rng, monkeypatch):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        clean = np.asarray(self._run(movie)[:, :, :])

        released = []
        loader_cls = self._arm_fake_cache(monkeypatch, released)
        calls = []
        real_vproj = loader_cls.v_projection

        def flaky_vproj(self, *a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake device OOM")
            return real_vproj(self, *a, **k)

        monkeypatch.setattr(loader_cls, "v_projection", flaky_vproj)
        pmd = self._run(movie)
        assert len(calls) == 2
        assert released
        np.testing.assert_allclose(np.asarray(pmd[:, :, :]), clean, atol=1e-5)

    def test_init_load_oom_drops_cache_and_retries(self, rng, monkeypatch):
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        clean = np.asarray(self._run(movie)[:, :, :])

        released = []
        loader_cls = self._arm_fake_cache(monkeypatch, released)
        calls = []
        real_crop = loader_cls.temporal_crop_with_filter

        def flaky_crop(self, *a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake device OOM")
            return real_crop(self, *a, **k)

        monkeypatch.setattr(loader_cls, "temporal_crop_with_filter", flaky_crop)
        pmd = self._run(movie)
        assert len(calls) == 2
        assert released, "the HBM movie cache must be dropped before the retry"
        np.testing.assert_allclose(np.asarray(pmd[:, :, :]), clean, atol=1e-5)

    def test_stats_pass_oom_drops_cache_and_retries(self, rng, monkeypatch):
        # Simulate a device OOM during the statistics pass while the
        # HBM movie cache is being built: the loader must drop the cache,
        # disable the policy, and recompute identical statistics.
        from localmd_tpu.loader import PMDLoader

        movie = (rng.standard_normal((300, 20, 20)) * 2 + 5).astype(np.float32)
        clean = PMDLoader(movie, background_rank=1, seed=0, cache_movie=False)

        calls = []
        real_init = PMDLoader._initialize_normalizers

        def flaky_init(self):
            calls.append(1)
            if len(calls) == 1:
                self._cache_building = True  # mid-build when the OOM lands
                raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake device OOM")
            return real_init(self)

        monkeypatch.setattr(PMDLoader, "_initialize_normalizers", flaky_init)
        loader = PMDLoader(movie, background_rank=1, seed=0, cache_movie=True)
        assert len(calls) == 2
        assert loader._cache is None and loader._cache_policy is False
        np.testing.assert_allclose(
            np.asarray(loader.mean_img), np.asarray(clean.mean_img), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(loader.std_img), np.asarray(clean.std_img), atol=1e-6
        )

    def test_non_oom_error_propagates(self, rng, monkeypatch):
        import localmd_tpu.pipeline as pl

        released = []
        self._arm_fake_cache(monkeypatch, released)

        def broken(*a, **k):
            raise ValueError("not an OOM")

        monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", broken)
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        with pytest.raises(ValueError, match="not an OOM"):
            self._run(movie)
        assert not released

    def test_oom_without_cache_propagates(self, rng, monkeypatch):
        # No HBM cache to drop => nothing to retry with; the error surfaces.
        import localmd_tpu.pipeline as pl

        def broken(*a, **k):
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: fake device OOM")

        monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", broken)
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            self._run(movie)

    def test_non_oom_runtime_error_not_retried(self, rng, monkeypatch):
        # A typed runtime error WITHOUT the RESOURCE_EXHAUSTED status code
        # (e.g. INTERNAL, a real compile bug) must never be mistaken for an
        # OOM: retrying would hide genuine failures behind a slower rerun.
        import localmd_tpu.pipeline as pl

        released = []
        self._arm_fake_cache(monkeypatch, released)
        calls = []

        def broken(*a, **k):
            calls.append(1)
            raise jax.errors.JaxRuntimeError("INTERNAL: compiler assertion")

        monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", broken)
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        with pytest.raises(jax.errors.JaxRuntimeError, match="INTERNAL"):
            self._run(movie)
        assert len(calls) == 1, "non-OOM runtime errors must not be retried"
        assert not released

    def test_untyped_oom_text_not_retried(self, rng, monkeypatch):
        # The retry scopes key on the TYPED runtime error, not message text:
        # an exception that merely quotes RESOURCE_EXHAUSTED (e.g. a user
        # denoiser logging a past failure) must propagate on the first raise.
        import localmd_tpu.pipeline as pl

        released = []
        self._arm_fake_cache(monkeypatch, released)
        calls = []

        def broken(*a, **k):
            calls.append(1)
            raise RuntimeError("RESOURCE_EXHAUSTED mentioned in a user error")

        monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", broken)
        movie = make_low_rank_movie(3, (300, 24, 24), rng)
        with pytest.raises(RuntimeError, match="user error"):
            self._run(movie)
        assert len(calls) == 1
        assert not released


class TestMaskPruning:
    """final_svd_reformat prunes by zero-MASKING s (device shapes stay
    rank-independent — no per-rank take program); PMDArray compacts the
    host-facing factors lazily via k2_keep."""

    def test_reformat_returns_mask(self, rng):
        from localmd_tpu.factorization import final_svd_reformat

        p = jnp.asarray(rng.standard_normal((40, 12)).astype(np.float32))
        # rank-6 V: half the singular values fall below the relative cutoff
        low = rng.standard_normal((12, 6)) @ rng.standard_normal((6, 200))
        v = jnp.asarray(low.astype(np.float32))
        r, s, vt, keep = final_svd_reformat(p, v, rel_tol=1e-3)
        assert r.shape[1] == 12 and vt.shape[0] == 12  # FULL width
        assert s.shape == (12,)
        assert keep.sum() < 12
        assert (s[~keep] == 0).all()  # pruned slots zeroed

    def test_pmdarray_k2_keep_compacts_host_factors(self, rng):
        from localmd_tpu.blocksparse import BlockSparseMatrix
        from localmd_tpu.ops.tiling import BlockGrid
        from localmd_tpu.pmd_array import PMDArray

        d = 20
        grid = BlockGrid(d, d, (10, 10))
        panels = rng.standard_normal(
            (grid.n_blocks, 100, 3)
        ).astype(np.float32)
        u = BlockSparseMatrix(
            jnp.asarray(panels), jnp.asarray(grid.rows), d * d,
            jnp.zeros((d * d, 1), np.float32),
            starts=jnp.asarray(grid.starts), block_shape=(10, 10),
        )
        k1 = grid.n_blocks * 3 + 1
        k2 = 8
        r = rng.standard_normal((k1, k2)).astype(np.float32)
        s_full = np.array([5, 4, 3, 2, 0, 0, 0, 0], np.float32)
        keep = s_full > 0
        v = rng.standard_normal((k2, 50)).astype(np.float32)
        counts = np.full(grid.n_blocks, 3)
        mean = np.zeros((d, d), np.float32)
        std = np.ones((d, d), np.float32)

        masked = PMDArray(u, jnp.asarray(r), s_full, jnp.asarray(v),
                          (50, d, d), "F", mean, std, counts=counts,
                          k2_keep=keep)
        compact = PMDArray(u, jnp.asarray(r[:, keep]), s_full[keep],
                           jnp.asarray(v[keep]), (50, d, d), "F", mean, std,
                           counts=counts)
        assert masked.rank == 4 == compact.rank
        np.testing.assert_array_equal(masked.s, compact.s)
        np.testing.assert_array_equal(masked.v, compact.v)
        np.testing.assert_array_equal(masked.r, compact.r)
        # device reconstruction identical (zeros annihilate pruned columns)
        np.testing.assert_allclose(
            masked[0:5, :, :], compact[0:5, :, :], atol=1e-5
        )
        # host path after close() stays compact and correct
        ref = masked[0:5, :, :]
        masked.close()
        assert masked.rank == 4
        np.testing.assert_allclose(masked[0:5, :, :], ref, atol=1e-5)
