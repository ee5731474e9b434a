import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from localmd_tpu.ops.linalg import (
    batched_truncated_random_svd,
    eigh_descending,
    projected_svd,
    subspace_eigh,
    svd_gram_left,
    svd_gram_right,
    truncated_random_svd,
)
from localmd_tpu.ops.noise import welch_noise_estimate
from localmd_tpu.ops.pooling import downsample_average_pooling
from localmd_tpu.ops.roughness import (
    evaluate_fitness,
    filter_by_failures,
    filter_by_failures_np,
    spatial_roughness_stat,
    temporal_roughness_stat,
)
from localmd_tpu.ops.tiling import (
    BlockGrid,
    extract_patches,
    flatten_fov,
    overlap_add,
    pyramid_weights,
    unflatten_fov,
)


class TestLinalg:
    def test_svd_gram_left_matches_numpy(self, rng):
        a = rng.standard_normal((8, 50)).astype(np.float32)
        u, s, vt = svd_gram_left(jnp.asarray(a))
        s_np = np.linalg.svd(a, compute_uv=False)
        # Gram squaring in f32 limits accuracy to ~1e-3 relative
        np.testing.assert_allclose(np.asarray(s), s_np, rtol=5e-3, atol=1e-3)
        # reconstruction
        np.testing.assert_allclose(
            np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt), a, atol=1e-3
        )
        # orthonormality
        np.testing.assert_allclose(np.asarray(u).T @ np.asarray(u), np.eye(8), atol=1e-4)

    def test_svd_gram_right_matches_numpy(self, rng):
        a = rng.standard_normal((60, 7)).astype(np.float32)
        u, s, vt = svd_gram_right(jnp.asarray(a))
        s_np = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(np.asarray(s), s_np, rtol=5e-3, atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt), a, atol=1e-3
        )

    @staticmethod
    def _eigh_case(rng, case):
        """(..., k, k) symmetric test matrices, float32."""
        if case == "psd_batch":
            m = rng.standard_normal((7, 30, 90)).astype(np.float32)
            return np.einsum("nik,njk->nij", m, m)
        if case == "decaying_spectrum":
            # strongly decaying singular values: the ill-conditioned case
            # the per-block Gram matrices produce
            m = rng.standard_normal((4, 20, 60)).astype(np.float32)
            m *= np.exp(-np.arange(20) * 0.8)[None, :, None].astype(np.float32)
            return np.einsum("nik,njk->nij", m, m)
        if case == "odd_dim_unbatched":
            m = rng.standard_normal((13, 40)).astype(np.float32)
            return m @ m.T
        if case == "indefinite_degenerate":
            # symmetric but indefinite, with exactly repeated eigenvalues
            q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
            vals = np.array([5.0, 3.0, 3.0, 1.0, 0.5, 0.0, 0.0, -0.5, -1.0,
                             -2.0, -2.0, -4.0])
            a = (q * vals[None, :]) @ q.T
            return ((a + a.T) / 2).astype(np.float32)
        assert case == "zero"
        return np.zeros((2, 6, 6), np.float32)

    @pytest.mark.parametrize(
        "case",
        ["psd_batch", "decaying_spectrum", "odd_dim_unbatched",
         "indefinite_degenerate", "zero"],
    )
    def test_eigh_descending_matches_numpy(self, rng, case):
        """Descending eigenvalues equal to float64 LAPACK's, orthonormal
        vectors, and V diag(vals) V^T reconstructs the input."""
        a = self._eigh_case(rng, case)
        vals, vecs = eigh_descending(jnp.asarray(a))
        vals, vecs = np.asarray(vals), np.asarray(vecs)
        k = a.shape[-1]
        scale = max(float(np.abs(a).max()), 1e-12)
        assert vals.shape == a.shape[:-1] and vecs.shape == a.shape
        assert (np.diff(vals, axis=-1) <= 1e-5 * scale).all()
        ref = np.linalg.eigvalsh(a.astype(np.float64))[..., ::-1]
        np.testing.assert_allclose(vals, ref, rtol=1e-4, atol=5e-5 * scale)
        gram = np.einsum("...ij,...ik->...jk", vecs, vecs)
        np.testing.assert_allclose(
            gram, np.broadcast_to(np.eye(k), gram.shape), atol=2e-5
        )
        recon = np.einsum("...ij,...j,...kj->...ik", vecs, vals, vecs)
        np.testing.assert_allclose(recon, a, atol=5e-5 * scale)

    @pytest.mark.parametrize("rank,k_sketch", [(40, 72), (100, 132)])
    def test_subspace_eigh_matches_full_eigh(self, rng, rank, k_sketch):
        # PSD with known rank bound: subspace_eigh's range capture is exact
        # up to f32, so top-`rank` eigenpairs match LAPACK's.
        m = 700
        b = rng.standard_normal((m, rank)).astype(np.float32)
        b *= np.exp(-np.arange(rank) * 0.1)[None, :].astype(np.float32)
        a = (b @ b.T).astype(np.float32)
        a = (a + a.T) / 2
        vals, vecs = subspace_eigh(jnp.asarray(a), k_sketch)
        vals, vecs = np.asarray(vals), np.asarray(vecs)
        assert vals.shape == (k_sketch,) and vecs.shape == (m, k_sketch)
        ref = np.linalg.eigvalsh(a.astype(np.float64))[::-1]
        scale = ref[0]
        np.testing.assert_allclose(vals[:rank], ref[:rank], rtol=1e-3, atol=1e-4 * scale)
        # tail eigenvalues are numerical-null noise
        assert np.abs(vals[rank:]).max() < 1e-4 * scale
        # eigenvectors orthonormal (Householder QR keeps even the numerical-
        # null sketch columns orthonormal) and the top block reconstructs a
        gram = vecs.T @ vecs
        np.testing.assert_allclose(gram, np.eye(k_sketch), atol=2e-4)
        lead = vecs[:, :rank]
        recon = (lead * vals[None, :rank]) @ lead.T
        np.testing.assert_allclose(recon, a, atol=2e-4 * scale)

    def test_truncated_random_svd_low_rank_recovery(self, rng):
        # Exactly rank-5 matrix: rSVD with rank 5 must reconstruct it.
        left = rng.standard_normal((200, 5)).astype(np.float32)
        right = rng.standard_normal((5, 120)).astype(np.float32)
        a = left @ right
        u, s, vt = truncated_random_svd(jnp.asarray(a), jax.random.PRNGKey(0), 5)
        recon = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
        rel = np.linalg.norm(recon - a) / np.linalg.norm(a)
        assert rel < 1e-4
        # singular values match numpy's top-5
        s_np = np.linalg.svd(a, compute_uv=False)[:5]
        np.testing.assert_allclose(np.asarray(s), s_np, rtol=1e-3)

    def test_truncated_random_svd_orthonormal_u(self, rng):
        a = rng.standard_normal((100, 80)).astype(np.float32)
        u, _, _ = truncated_random_svd(jnp.asarray(a), jax.random.PRNGKey(1), 10)
        gram = np.asarray(u).T @ np.asarray(u)
        np.testing.assert_allclose(gram, np.eye(10), atol=1e-4)

    def test_batched_matches_single(self, rng):
        mats = rng.standard_normal((3, 50, 40)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(2), 3)
        ub, sb, vb = batched_truncated_random_svd(jnp.asarray(mats), keys, 6)
        for i in range(3):
            u1, s1, v1 = truncated_random_svd(jnp.asarray(mats[i]), keys[i], 6)
            np.testing.assert_allclose(np.asarray(ub[i]), np.asarray(u1), atol=1e-5)
            np.testing.assert_allclose(np.asarray(sb[i]), np.asarray(s1), atol=1e-5)

    def test_projected_svd(self, rng):
        p = np.linalg.qr(rng.standard_normal((40, 12)))[0].astype(np.float32)
        v = rng.standard_normal((12, 300)).astype(np.float32)
        r, s, vt = projected_svd(jnp.asarray(p), jnp.asarray(v))
        recon = np.asarray(r) @ np.diag(np.asarray(s)) @ np.asarray(vt)
        np.testing.assert_allclose(recon, p @ v, atol=1e-3)
        # rows of vt orthonormal (nonzero s part)
        vt_np = np.asarray(vt)
        np.testing.assert_allclose(vt_np @ vt_np.T, np.eye(12), atol=1e-3)


class TestWelchNoise:
    def test_matches_scipy_welch(self, rng):
        t = 1024
        traces = rng.standard_normal((5, t)).astype(np.float32)
        ours = np.asarray(welch_noise_estimate(jnp.asarray(traces)))
        # scipy oracle replicating the reference formula
        # (reference preprocessing_utils.py:28-37)
        f, pxx = scipy.signal.welch(traces, noverlap=128, nperseg=256, axis=-1)
        band = pxx[:, 65:129] * 0.5
        expected = np.sqrt(band.mean(axis=-1))
        np.testing.assert_allclose(ours, expected, rtol=1e-4)

    def test_white_noise_sigma_recovery(self, rng):
        sigma = 3.7
        traces = sigma * rng.standard_normal((20, 2048)).astype(np.float32)
        est = np.asarray(welch_noise_estimate(jnp.asarray(traces)))
        np.testing.assert_allclose(est.mean(), sigma, rtol=0.05)

    def test_batch_shape(self, rng):
        x = rng.standard_normal((4, 6, 512)).astype(np.float32)
        out = welch_noise_estimate(jnp.asarray(x))
        assert out.shape == (4, 6)

    def test_ref_compat_matches_jax_welch(self, rng):
        """welch_noise_estimate_ref_compat vs jax.scipy.signal.welch driven
        exactly the way the reference drives it (nperseg unspecified ->
        nperseg = len(trace); reference preprocessing_utils.py:28-37)."""
        import jax.scipy.signal as jss

        from localmd_tpu.ops.noise import welch_noise_estimate_ref_compat

        for t in (256, 300, 512, 1024):
            traces = rng.standard_normal((4, t)).astype(np.float32) * 1.7
            ours = np.asarray(
                welch_noise_estimate_ref_compat(jnp.asarray(traces))
            )
            expected = []
            for tr in traces:
                _, pxx = jss.welch(jnp.asarray(tr), noverlap=128)
                band = np.asarray(pxx)[65:129] * 0.5
                expected.append(np.sqrt(band.mean()))
            np.testing.assert_allclose(ours, np.asarray(expected), rtol=2e-5,
                                       err_msg=f"t={t}")

    def test_ref_compat_rejects_short_traces(self, rng):
        from localmd_tpu.ops.noise import welch_noise_estimate_ref_compat

        with pytest.raises(ValueError):
            welch_noise_estimate_ref_compat(
                jnp.asarray(rng.standard_normal((2, 200)).astype(np.float32))
            )


class TestRoughness:
    def _spatial_oracle(self, u):
        vert = np.abs(np.diff(u, axis=0))
        horiz = np.abs(np.diff(u, axis=1))
        avg = (vert.sum() + horiz.sum()) / (vert.size + horiz.size)
        return avg / np.abs(u).mean()

    def _temporal_oracle(self, v):
        return np.abs(v[:-2] + v[2:] - 2 * v[1:-1]).mean() / np.abs(v).mean()

    def test_spatial_stat(self, rng):
        u = rng.standard_normal((16, 12)).astype(np.float32)
        ours = float(spatial_roughness_stat(jnp.asarray(u)))
        np.testing.assert_allclose(ours, self._spatial_oracle(u), rtol=1e-5)

    def test_temporal_stat(self, rng):
        v = rng.standard_normal(200).astype(np.float32)
        ours = float(temporal_roughness_stat(jnp.asarray(v)))
        np.testing.assert_allclose(ours, self._temporal_oracle(v), rtol=1e-5)

    def test_batched_stats(self, rng):
        u = rng.standard_normal((3, 5, 16, 12)).astype(np.float32)
        out = np.asarray(spatial_roughness_stat(jnp.asarray(u)))
        assert out.shape == (3, 5)
        np.testing.assert_allclose(out[1, 2], self._spatial_oracle(u[1, 2]), rtol=1e-5)

    def test_smooth_vs_noise_separation(self, rng):
        # smooth gaussian blob should have much lower roughness than noise
        x, y = np.meshgrid(np.linspace(-2, 2, 20), np.linspace(-2, 2, 20))
        blob = np.exp(-(x**2 + y**2)).astype(np.float32)
        noise = rng.standard_normal((20, 20)).astype(np.float32)
        assert float(spatial_roughness_stat(jnp.asarray(blob))) < 0.5 * float(
            spatial_roughness_stat(jnp.asarray(noise))
        )

    def test_evaluate_fitness(self, rng):
        imgs = rng.standard_normal((4, 10, 10)).astype(np.float32)
        traces = rng.standard_normal((4, 50)).astype(np.float32)
        out = np.asarray(
            evaluate_fitness(jnp.asarray(imgs), jnp.asarray(traces), 1e9, 1e9)
        )
        np.testing.assert_array_equal(out, np.ones(4, dtype=np.int32))
        out0 = np.asarray(
            evaluate_fitness(jnp.asarray(imgs), jnp.asarray(traces), -1.0, 1e9)
        )
        np.testing.assert_array_equal(out0, np.zeros(4, dtype=np.int32))

    @pytest.mark.parametrize("max_fails", [1, 2, 3])
    def test_filter_by_failures_matches_oracle(self, rng, max_fails):
        for _ in range(20):
            dec = rng.random(12) > 0.4
            ours = np.asarray(filter_by_failures(jnp.asarray(dec), max_fails))
            oracle = filter_by_failures_np(dec, max_fails)
            np.testing.assert_array_equal(ours, oracle)

    def test_filter_by_failures_batched(self, rng):
        dec = rng.random((5, 10)) > 0.5
        ours = np.asarray(filter_by_failures(jnp.asarray(dec), 2))
        for i in range(5):
            np.testing.assert_array_equal(ours[i], filter_by_failures_np(dec[i], 2))


class TestPooling:
    def test_matches_manual_average(self, rng):
        x = rng.standard_normal((8, 8, 3)).astype(np.float32)
        out = np.asarray(downsample_average_pooling(jnp.asarray(x), 2))
        assert out.shape == (4, 4, 3)
        expected = x.reshape(4, 2, 4, 2, 3).mean(axis=(1, 3))
        np.testing.assert_allclose(out, expected, rtol=1e-5)

    def test_uneven_edges_count_normalized(self, rng):
        x = rng.standard_normal((5, 7, 2)).astype(np.float32)
        out = np.asarray(downsample_average_pooling(jnp.asarray(x), 2))
        assert out.shape == (3, 4, 2)
        # last row pools only 1 row of pixels; value = average of those
        np.testing.assert_allclose(out[2, 0], x[4, 0:2].mean(axis=0), rtol=1e-5)

    def test_batched(self, rng):
        x = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
        out = np.asarray(downsample_average_pooling(jnp.asarray(x), 2))
        assert out.shape == (6, 4, 4, 3)
        single = np.asarray(downsample_average_pooling(jnp.asarray(x[2]), 2))
        np.testing.assert_allclose(out[2], single, rtol=1e-5)


class TestTiling:
    def test_pyramid_weights_match_reference_construction(self):
        # replicate the reference quadrant-mirror construction for even sizes
        # (reference decomposition.py:742-750)
        for (b1, b2) in [(16, 16), (32, 20), (10, 14)]:
            w_ref = np.ones((b1, b2), dtype=np.float32)
            hbh, hbw = b1 // 2, b2 // 2
            w_ref[:hbh, :hbw] += np.minimum(
                np.tile(np.arange(0, hbw), (hbh, 1)),
                np.tile(np.arange(0, hbh), (hbw, 1)).T,
            )
            w_ref[:hbh, hbw:] = np.fliplr(w_ref[:hbh, :hbw])
            w_ref[hbh:, :] = np.flipud(w_ref[:hbh, :])
            np.testing.assert_array_equal(pyramid_weights(b1, b2), w_ref)

    def test_grid_starts_cover_fov(self):
        grid = BlockGrid(100, 75, (32, 20))
        b1, b2 = grid.block_sizes
        covered = np.zeros((100, 75), dtype=bool)
        for (k, j) in grid.starts:
            covered[k : k + b1, j : j + b2] = True
        assert covered.all()
        assert (grid.starts[:, 0] + b1 <= 100).all()
        assert (grid.starts[:, 1] + b2 <= 75).all()

    def test_rows_match_forder_pixels(self):
        grid = BlockGrid(10, 8, (10, 8))
        # single block covering everything: rows = F-order ids of block pixels
        expected = np.arange(80).reshape((10, 8), order="F").flatten(order="F")
        np.testing.assert_array_equal(grid.rows[0], expected)

    def test_flatten_roundtrip(self, rng):
        x = rng.standard_normal((4, 6, 3)).astype(np.float32)
        flat = flatten_fov(jnp.asarray(x))
        # F-order semantics: pixel id i + j*d1
        np.testing.assert_allclose(
            np.asarray(flat), x.reshape(24, 3, order="F"), rtol=1e-6
        )
        back = unflatten_fov(flat, 4, 6)
        np.testing.assert_allclose(np.asarray(back), x, rtol=1e-6)

    def test_extract_patches(self, rng):
        data = rng.standard_normal((20, 18, 5)).astype(np.float32)
        starts = jnp.asarray([[0, 0], [4, 6], [10, 10]])
        patches = np.asarray(extract_patches(jnp.asarray(data), starts, 8, 8))
        np.testing.assert_allclose(patches[1], data[4:12, 6:14, :])

    def test_overlap_add(self, rng):
        panels = rng.standard_normal((2, 4, 3)).astype(np.float32)
        rows = jnp.asarray([[0, 1, 2, 3], [2, 3, 4, 5]])
        out = np.asarray(overlap_add(jnp.asarray(panels), rows, 6))
        expected = np.zeros((6, 3), dtype=np.float32)
        expected[0:4] += panels[0]
        expected[2:6] += panels[1]
        np.testing.assert_allclose(out, expected, rtol=1e-5)


class TestPowerIterations:
    def test_power_iters_improve_slow_decay(self, rng):
        import jax
        # slowly decaying spectrum: plain sketch struggles, power iters help
        d, t, r = 300, 200, 10
        u_true = np.linalg.qr(rng.standard_normal((d, t)))[0][:, :t]
        s_true = (1.0 / np.arange(1, t + 1) ** 0.5).astype(np.float32)
        v_true = np.linalg.qr(rng.standard_normal((t, t)))[0]
        a = (u_true * s_true) @ v_true.T

        def err(power_iters):
            u, s, vt = truncated_random_svd(
                jnp.asarray(a), jax.random.PRNGKey(0), r, 10, power_iters
            )
            recon = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
            return np.linalg.norm(recon - a)

        optimal = np.sqrt((s_true[r:] ** 2).sum())
        e0, e2 = err(0), err(2)
        assert e2 <= e0 + 1e-6
        assert e2 < 1.05 * optimal, (e2, optimal)


class TestBatchedRSVD:
    def test_batched_rsvd_matches_per_item(self, rng):
        # the natively-batched rSVD (explicit batch dims instead of vmap)
        # must equal the per-item reference
        from localmd_tpu.ops.linalg import (
            batched_truncated_random_svd,
            truncated_random_svd,
        )

        mats = jnp.asarray(rng.standard_normal((5, 80, 60)).astype(np.float32))
        keys = jax.random.split(jax.random.PRNGKey(3), 5)
        u, s, vt = batched_truncated_random_svd(mats, keys, 6)
        for i in range(5):
            ui, si, vti = truncated_random_svd(mats[i], keys[i], 6)
            np.testing.assert_allclose(np.asarray(s[i]), np.asarray(si),
                                       rtol=2e-4, atol=1e-3)
            rec_b = np.asarray(u[i]) * np.asarray(s[i]) @ np.asarray(vt[i])
            rec_r = np.asarray(ui) * np.asarray(si) @ np.asarray(vti)
            np.testing.assert_allclose(rec_b, rec_r, atol=2e-3)
