import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localmd_tpu.engine import (
    pack_components,
    single_block_md_batched,
    single_residual_block_md_batched,
    temporal_projector_batched,
    threshold_heuristic,
    windowed_pmd_batched,
)
from localmd_tpu.ops.roughness import filter_by_failures_np
from localmd_tpu.ops.tiling import flatten_fov


def low_rank_blocks(rng, n=4, b1=16, b2=16, t=120, rank=3, noise=0.05):
    """Batch of blocks, each an exact rank-`rank` movie + small noise."""
    u = rng.standard_normal((n, b1 * b2, rank)).astype(np.float32)
    # smooth the spatial factors so they pass the roughness test
    u_img = u.reshape(n, b1, b2, rank)
    for _ in range(6):
        u_img = 0.2 * (
            u_img
            + np.roll(u_img, 1, 1) + np.roll(u_img, -1, 1)
            + np.roll(u_img, 1, 2) + np.roll(u_img, -1, 2)
        )
    u = u_img.reshape(n, b1 * b2, rank)
    v = rng.standard_normal((n, rank, t)).astype(np.float32)
    # smooth temporal traces too
    for _ in range(4):
        v = 0.5 * v + 0.25 * (np.roll(v, 1, 2) + np.roll(v, -1, 2))
    blocks = np.einsum("npr,nrt->npt", u, v) * 3.0
    blocks += noise * rng.standard_normal(blocks.shape).astype(np.float32)
    return blocks.reshape(n, b1, b2, t).astype(np.float32)


class TestSingleBlockMD:
    def test_reconstruction_of_low_rank_blocks(self, rng):
        blocks = low_rank_blocks(rng, n=4, rank=3)
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        u, dec, v = single_block_md_batched(
            jnp.asarray(blocks), keys, 6, 4, 2, 1e9, 1e9
        )
        # u orthonormal per block
        g = np.einsum("npr,nps->nrs", np.asarray(u), np.asarray(u))
        for i in range(4):
            np.testing.assert_allclose(g[i], np.eye(6), atol=1e-3)
        # rank-6 basis captures the rank-3 signal: compare against the
        # OPTIMAL rank-6 truncated SVD error (the noise floor)
        flat = np.asarray(flatten_fov(jnp.asarray(blocks)))
        recon = np.einsum("npr,nrt->npt", np.asarray(u), np.asarray(v))
        rel = np.linalg.norm(recon - flat) / np.linalg.norm(flat)
        s_all = np.linalg.svd(flat, compute_uv=False)
        optimal = np.sqrt((s_all[:, 6:] ** 2).sum()) / np.linalg.norm(flat)
        assert rel < 1.2 * optimal + 1e-3, (rel, optimal)

    def test_qr_fast_path_matches_svd_path(self, rng):
        # With identity denoisers the middle orthonormalizations take the
        # CholeskyQR2 fast path; a non-identity (but functionally identity)
        # spatial denoiser forces the reference Gram-SVD path. The final
        # canonical SVD makes both mathematically identical: compare the
        # reconstruction product and the per-component magnitudes.
        blocks = low_rank_blocks(rng, n=3, rank=3)
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        u_fast, dec_fast, v_fast = single_block_md_batched(
            jnp.asarray(blocks), keys, 5, 4, 2, 1e9, 1e9
        )
        u_svd, dec_svd, v_svd = single_block_md_batched(
            jnp.asarray(blocks), keys, 5, 4, 2, 1e9, 1e9,
            spatial_denoiser=lambda x: x * 1.0,
        )
        prod_fast = np.einsum("npr,nrt->npt", np.asarray(u_fast), np.asarray(v_fast))
        prod_svd = np.einsum("npr,nrt->npt", np.asarray(u_svd), np.asarray(v_svd))
        scale = np.abs(prod_svd).max()
        np.testing.assert_allclose(prod_fast, prod_svd, atol=2e-4 * scale)
        # singular values (folded into v rows) must agree
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(v_fast), axis=-1),
            np.linalg.norm(np.asarray(v_svd), axis=-1),
            rtol=1e-3, atol=1e-4,
        )
        np.testing.assert_array_equal(np.asarray(dec_fast), np.asarray(dec_svd))

    def test_decisions_keep_smooth_components(self, rng):
        blocks = low_rank_blocks(rng, n=2, rank=2, noise=0.01)
        keys = jax.random.split(jax.random.PRNGKey(1), 2)
        # realistic thresholds from the noise null
        s_thr, t_thr = threshold_heuristic((16, 16, 120), iters=40, key=jax.random.PRNGKey(2))
        _, dec, _ = single_block_md_batched(
            jnp.asarray(blocks), keys, 6, 4, 2, s_thr, t_thr
        )
        dec = np.asarray(dec)
        # the two leading (signal) components of each block must be kept
        assert dec[:, :2].all(), dec


class TestResidualMD:
    def test_residual_orthogonal_to_existing(self, rng):
        blocks = low_rank_blocks(rng, n=3, rank=4)
        keys = jax.random.split(jax.random.PRNGKey(3), 3)
        u0, _, _ = single_block_md_batched(jnp.asarray(blocks), keys, 2, 4, 2, 1e9, 1e9)
        # pad existing to 5 slots
        existing = jnp.concatenate(
            [u0, jnp.zeros((3, u0.shape[1], 3))], axis=2
        )
        u1, dec, v1 = single_residual_block_md_batched(
            jnp.asarray(blocks), existing, keys, 2, 4, 1e9, 1e9
        )
        # new components orthogonal to existing basis
        cross = np.einsum("npr,nps->nrs", np.asarray(existing), np.asarray(u1))
        np.testing.assert_allclose(cross, 0.0, atol=1e-3)


class TestPackComponents:
    def test_packing_respects_filter_and_slots(self, rng):
        n, p, r, slots = 3, 10, 5, 6
        u_new = rng.standard_normal((n, p, r)).astype(np.float32)
        decisions = np.array(
            [[1, 1, 0, 1, 1], [0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], dtype=np.int32
        )
        acc = jnp.zeros((n, p, slots))
        counts = jnp.asarray([0, 2, 4], dtype=jnp.int32)
        acc2, counts2 = pack_components(
            jnp.asarray(u_new), jnp.asarray(decisions), acc, counts, 1
        )
        acc2, counts2 = np.asarray(acc2), np.asarray(counts2)
        for i in range(n):
            keep = filter_by_failures_np(decisions[i] > 0, 1)
            kept_cols = u_new[i][:, keep]
            start = int(np.asarray(counts)[i])
            n_fit = min(kept_cols.shape[1], slots - start)
            assert counts2[i] == start + n_fit
            np.testing.assert_allclose(
                acc2[i][:, start : start + n_fit], kept_cols[:, :n_fit], atol=1e-6
            )
            # untouched slots stay zero
            np.testing.assert_allclose(acc2[i][:, start + n_fit :], 0.0, atol=1e-6)


class TestWindowedPMD:
    def test_single_window_equals_md_plus_pack(self, rng):
        blocks = low_rank_blocks(rng, n=2, rank=2)
        res = windowed_pmd_batched(
            jnp.asarray(blocks), jax.random.PRNGKey(5), 120, 4, 1e9, 1e9, 1, 4, 2
        )
        assert res.spatial.shape == (2, 256, 4)
        assert (np.asarray(res.counts) == 4).all()  # huge thresholds keep all
        # temporal = spatial^T @ blocks
        flat = np.asarray(flatten_fov(jnp.asarray(blocks)))
        expected_v = np.einsum("nps,npt->nst", np.asarray(res.spatial), flat)
        np.testing.assert_allclose(np.asarray(res.temporal), expected_v, atol=1e-2)

    def test_multi_window_grows_basis(self, rng):
        # two windows; block signal changes halfway so window 2 adds comps
        b1 = b2 = 16
        t = 160
        u_a = rng.standard_normal((b1 * b2, 2)).astype(np.float32)
        u_b = rng.standard_normal((b1 * b2, 2)).astype(np.float32)
        v = rng.standard_normal((2, t // 2)).astype(np.float32)
        first = (u_a @ v).reshape(b1, b2, t // 2)
        second = (u_b @ v).reshape(b1, b2, t // 2)
        block = np.concatenate([first, second], axis=2)[None]
        # small noise keeps the residual full-rank (a rank-deficient residual
        # gives exact-zero singular values whose Gram-eigh columns are ~zero
        # rather than orthonormal junk — dropped downstream either way)
        block = block + 0.05 * np.random.default_rng(0).standard_normal(block.shape)
        block = block.astype(np.float32)
        res = windowed_pmd_batched(
            jnp.asarray(block), jax.random.PRNGKey(6), 80, 6, 1e9, 1e9, 1, 4, 2
        )
        assert int(np.asarray(res.counts)[0]) == 6
        # basis columns orthonormal even across windows
        u = np.asarray(res.spatial)[0]
        np.testing.assert_allclose(u.T @ u, np.eye(6), atol=1e-3)


@pytest.mark.slow
class TestStragglerFallback:
    """The windowed loop's zero-count fallback re-runs the full two-stage
    kernel on a COMPACTED fixed-capacity subset (not the whole batch).
    Reference parity note: filter_by_failures keeps every block's FIRST
    component even when it fails (reference evaluation.py:210-218), so
    counts >= 1 after window 0 — the fallback is a safety net whose cost
    must still be bounded if it ever fires."""

    def test_first_failure_is_kept_reference_semantics(self, rng):
        """A window whose every component fails the fitness test still packs
        exactly min(mcf, r) components — matching the reference host oracle."""
        from localmd_tpu.engine import pack_components

        u = jnp.asarray(rng.standard_normal((1, 64, 4)).astype(np.float32))
        dec = jnp.zeros((1, 4), jnp.int32)
        acc = jnp.zeros((1, 64, 4), jnp.float32)
        counts = jnp.zeros((1,), jnp.int32)
        for mcf in (1, 2, 3):
            _, c = pack_components(u, dec, acc, counts, mcf)
            oracle = filter_by_failures_np(np.zeros(4, bool), mcf).sum()
            assert int(np.asarray(c)[0]) == int(oracle) == mcf

    def test_gathered_fallback_equals_full_fallback(self, rng):
        """With one zero-count straggler among 16 blocks, the gathered
        cap-sized tier must produce exactly the same output as the
        all-blocks tier — only cheaper."""
        from localmd_tpu.engine import _fallback_rerun, identity

        n, b1, b2, wl = 16, 16, 16, 80
        window = jnp.asarray(
            low_rank_blocks(rng, n=n, b1=b1, b2=b2, t=wl, rank=2, noise=0.05)
        )
        keys = jax.random.split(jax.random.PRNGKey(4), n)
        u_r = jnp.asarray(rng.standard_normal((n, b1 * b2, 4)).astype(np.float32))
        dec_r = jnp.asarray((rng.random((n, 4)) > 0.5).astype(np.int32))
        is_zero = jnp.zeros((n,), bool).at[5].set(True)
        kw = dict(
            max_rank=4, temporal_avg_factor=4, spatial_avg_factor=2,
            spatial_threshold=1e9, temporal_threshold=1e9,
            spatial_denoiser=identity, temporal_denoiser=identity,
        )
        n_zero = jnp.sum(is_zero.astype(jnp.int32))
        u_g, dec_g = _fallback_rerun(
            window, keys, u_r, dec_r, is_zero, n_zero, 2, **kw
        )
        u_f, dec_f = _fallback_rerun(
            window, keys, u_r, dec_r, is_zero, n_zero, n, **kw
        )
        np.testing.assert_allclose(np.asarray(u_g), np.asarray(u_f), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(dec_g), np.asarray(dec_f))
        # non-straggler blocks keep their residual-kernel results untouched
        mask = np.ones(n, bool)
        mask[5] = False
        np.testing.assert_array_equal(
            np.asarray(u_g)[mask], np.asarray(u_r)[mask]
        )
        # the straggler actually got re-decomposed
        assert not np.allclose(np.asarray(u_g)[5], np.asarray(u_r)[5])

    def test_no_zero_blocks_is_noop_and_overflow_falls_through(self, rng):
        from localmd_tpu.engine import _fallback_rerun, identity

        n, b1, b2, wl = 16, 12, 12, 40
        window = jnp.asarray(
            low_rank_blocks(rng, n=n, b1=b1, b2=b2, t=wl, rank=2, noise=0.05)
        )
        keys = jax.random.split(jax.random.PRNGKey(4), n)
        u_r = jnp.asarray(rng.standard_normal((n, b1 * b2, 3)).astype(np.float32))
        dec_r = jnp.ones((n, 3), jnp.int32)
        kw = dict(
            max_rank=3, temporal_avg_factor=4, spatial_avg_factor=2,
            spatial_threshold=1e9, temporal_threshold=1e9,
            spatial_denoiser=identity, temporal_denoiser=identity,
        )
        # no zeros -> no-op tier
        none = jnp.zeros((n,), bool)
        u0, dec0 = _fallback_rerun(
            window, keys, u_r, dec_r, none, jnp.int32(0), 2, **kw
        )
        np.testing.assert_array_equal(np.asarray(u0), np.asarray(u_r))
        # more zeros than the capacity -> all-blocks tier, still correct
        many = jnp.ones((n,), bool).at[0].set(False)
        n_zero = jnp.sum(many.astype(jnp.int32))
        u_m, _ = _fallback_rerun(
            window, keys, u_r, dec_r, many, n_zero, 2, **kw
        )
        u_full, _ = _fallback_rerun(
            window, keys, u_r, dec_r, many, n_zero, n, **kw
        )
        np.testing.assert_allclose(np.asarray(u_m), np.asarray(u_full), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(u_m)[0], np.asarray(u_r)[0])


class TestThresholdHeuristic:
    def test_thresholds_reasonable(self):
        s_thr, t_thr = threshold_heuristic(
            (16, 16, 100), iters=64, key=jax.random.PRNGKey(0)
        )
        # roughness stats of pure noise concentrate near these values;
        # thresholds (5th pctile) must be positive and O(1)
        assert 0.5 < s_thr < 2.0, s_thr
        assert 1.0 < t_thr < 3.0, t_thr

    def test_deterministic_given_key(self):
        a = threshold_heuristic((12, 12, 80), iters=32, key=jax.random.PRNGKey(1))
        b = threshold_heuristic((12, 12, 80), iters=32, key=jax.random.PRNGKey(1))
        assert a == b

    @pytest.mark.slow
    def test_memoized_per_key(self, monkeypatch):
        # Same (config, key) -> kernel runs once; different key -> runs again.
        from localmd_tpu import engine as eng

        calls = {"n": 0}
        real = eng._threshold_kernel

        def counting(*args, **kwargs):
            calls["n"] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(eng, "_threshold_kernel", counting)
        monkeypatch.setattr(eng, "_threshold_cache", {})
        a = eng.threshold_heuristic((14, 14, 80), iters=32, key=jax.random.PRNGKey(7))
        b = eng.threshold_heuristic((14, 14, 80), iters=32, key=jax.random.PRNGKey(7))
        assert calls["n"] == 1 and a == b
        # as_device hits the same cache entry (device scalars)
        sd, td = eng.threshold_heuristic(
            (14, 14, 80), iters=32, key=jax.random.PRNGKey(7), as_device=True
        )
        assert calls["n"] == 1
        assert (float(sd), float(td)) == a
        c = eng.threshold_heuristic((14, 14, 80), iters=32, key=jax.random.PRNGKey(8))
        assert calls["n"] == 2 and c != a
        # an ambient matmul-precision change must NOT hit the cache (the
        # simulated rSVDs genuinely differ across precisions on devices
        # whose default f32 matmul is reduced-precision)
        with jax.default_matmul_precision("highest"):
            eng.threshold_heuristic((14, 14, 80), iters=32, key=jax.random.PRNGKey(7))
        assert calls["n"] == 3


class TestFusedSteps:
    @pytest.mark.slow
    def test_window0_chunk_step_equals_separate_calls(self, rng):
        import jax
        import jax.numpy as jnp
        from localmd_tpu.engine import window0_chunk_step
        from localmd_tpu.ops.tiling import BlockGrid, extract_patches, flatten_fov

        data = rng.standard_normal((40, 40, 120)).astype(np.float32)
        grid = BlockGrid(40, 40, (16, 16))
        starts = jnp.asarray(grid.starts)
        keys = jax.random.split(jax.random.PRNGKey(0), grid.n_blocks)

        acc, counts, v_fit = window0_chunk_step(
            jnp.asarray(data), starts, keys, 16, 16, 4, 4, 2, 1e9, 1e9, 1,
        )
        # oracle: separate extract + md + pack + project
        patches = extract_patches(jnp.asarray(data), starts, 16, 16)
        u, dec, _ = single_block_md_batched(patches, keys, 4, 4, 2, 1e9, 1e9)
        acc0 = jnp.zeros((grid.n_blocks, 256, 4))
        c0 = jnp.zeros((grid.n_blocks,), jnp.int32)
        acc_ref, counts_ref = pack_components(u, dec, acc0, c0, 1)
        v_ref = temporal_projector_batched(acc_ref, flatten_fov(patches))
        np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(counts_ref))
        np.testing.assert_allclose(np.asarray(v_fit), np.asarray(v_ref), atol=1e-3)

    @pytest.mark.slow
    def test_window0_t_used_crops_time(self, rng):
        import jax
        import jax.numpy as jnp
        from localmd_tpu.engine import window0_chunk_step

        data = rng.standard_normal((24, 24, 130)).astype(np.float32)
        grid_starts = jnp.asarray([[0, 0], [0, 12], [12, 0], [12, 12]])
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        # t_used=120 must equal running on a pre-cropped movie
        a1, c1, v1 = window0_chunk_step(
            jnp.asarray(data), grid_starts, keys, 12, 12, 3, 4, 2, 1e9, 1e9, 1,
            t_used=120,
        )
        a2, c2, v2 = window0_chunk_step(
            jnp.asarray(data[:, :, :120]), grid_starts, keys, 12, 12, 3, 4, 2,
            1e9, 1e9, 1,
        )
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=1e-6)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)

    def test_windowed_early_stop_when_full(self, rng):
        # max_rank small so window 1 fills every block; later windows skipped
        blocks = low_rank_blocks(rng, n=2, rank=3, t=160)
        res = windowed_pmd_batched(
            jnp.asarray(blocks), jax.random.PRNGKey(9), 40, 2, 1e9, 1e9, 1, 4, 2,
        )
        assert (np.asarray(res.counts) == 2).all()
