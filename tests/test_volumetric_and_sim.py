import numpy as np
import pytest

from localmd_tpu.sim import (
    two_photon_movie,
    voltage_movie,
    volumetric_stack,
    widefield_movie,
)
from localmd_tpu.volumetric import VolumetricPMD, volumetric_decomposition

# multi-plane pipeline runs: quick lane skips this module (pytest -m 'not slow')
pytestmark = pytest.mark.slow


class TestSim:
    def test_two_photon_shapes_and_stats(self):
        m = np.asarray(two_photon_movie(32, 28, 400, n_cells=5, seed=1))
        assert m.shape == (400, 32, 28)
        assert m.mean() > 90  # camera offset present
        # temporal variance concentrated at cells, noise floor elsewhere
        v = m.var(axis=0)
        assert v.max() > 3 * np.median(v)

    def test_widefield_movie(self):
        m = np.asarray(widefield_movie(48, 48, 300, n_sources=4, seed=2))
        assert m.shape == (300, 48, 48)

    def test_voltage_movie(self):
        m = np.asarray(voltage_movie(24, 24, 600, n_cells=4, seed=3))
        assert m.shape == (600, 24, 24)

    def test_volumetric_stack(self):
        planes = volumetric_stack(n_planes=2, d1=24, d2=24, t=300)
        assert len(planes) == 2
        assert planes[0].shape == (300, 24, 24)


class TestVolumetric:
    def test_per_plane_decomposition(self):
        planes = volumetric_stack(n_planes=2, d1=24, d2=24, t=300, seed=5)
        vol = volumetric_decomposition(
            planes, (12, 12), frame_range=300, max_components=6,
            background_rank=1, temporal_avg_factor=4, sim_iters=20, seed=0,
        )
        assert vol.shape == (300, 2, 24, 24)
        assert vol.ndim == 4
        # per-plane reconstruction quality against the raw movie
        for z in range(2):
            raw = np.asarray(planes[z])
            rec = vol.planes[z][:, :, :]
            rel = np.linalg.norm(rec - raw) / np.linalg.norm(raw)
            assert rel < 0.5, rel  # denoised: below 1.0 by a margin

    def test_four_d_indexing(self):
        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=6)
        vol = volumetric_decomposition(
            planes, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        one = vol[5]
        assert one.shape == (2, 20, 20)
        sub = vol[0:4, 0]
        assert sub.shape == (4, 20, 20)

    def test_four_d_slicing_stays_on_device(self, monkeypatch):
        # pipeline-built planes hold live device factors: 4-D slicing must
        # route through each plane's on-device path and never materialize
        # the scipy CSR export (mirrors the 2-D spy test in
        # tests/test_pipeline.py)
        from localmd_tpu.pmd_array import PMDArray

        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=8)
        vol = volumetric_decomposition(
            planes, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        assert all(p._blocksparse is not None for p in vol.planes)

        calls = []
        orig = PMDArray._ensure_csr

        def spy(self_):
            calls.append(1)
            return orig(self_)

        monkeypatch.setattr(PMDArray, "_ensure_csr", spy)
        out = vol[0:4, :, 2:12, 3:13]
        assert out.shape == (4, 2, 10, 10)
        _ = vol[5]
        _ = vol[0:3, 1, 0:5]
        assert not calls, "volumetric slicing must never build the CSR"
        monkeypatch.setattr(PMDArray, "_ensure_csr", orig)

        # device and host paths agree
        dev = vol[0:4, :, 2:12, 3:13]
        for p in vol.planes:
            p.u  # materialize host factors
            p.r
        saved = [p._blocksparse for p in vol.planes]
        for p in vol.planes:
            p._blocksparse = None
        try:
            host = vol[0:4, :, 2:12, 3:13]
        finally:
            for p, b in zip(vol.planes, saved):
                p._blocksparse = b
        np.testing.assert_allclose(dev, host, atol=1e-4)

    def test_close_releases_all_planes(self):
        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=9)
        vol = volumetric_decomposition(
            planes, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        before = vol[0:2, :, 0:5, 0:5]
        vol.close()  # materialize=True: host factors survive
        assert all(p._blocksparse is None for p in vol.planes)
        after = vol[0:2, :, 0:5, 0:5]
        np.testing.assert_allclose(after, before, atol=1e-4)

        # context manager delegates to close()
        planes2 = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=10)
        with volumetric_decomposition(
            planes2, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        ) as vol2:
            assert vol2.shape == (280, 2, 20, 20)
        assert all(p._blocksparse is None for p in vol2.planes)

    def test_save(self, tmp_path):
        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=7)
        vol = volumetric_decomposition(
            planes, (10, 10), frame_range=280, max_components=4,
            background_rank=1, temporal_avg_factor=4, sim_iters=15, seed=0,
        )
        paths = vol.save(str(tmp_path / "vol"))
        assert len(paths) == 2
        import os

        assert all(os.path.exists(p) for p in paths)


class TestVolumetricParallel:
    """Scale-out paths for BASELINE.json config 5 (per-plane PMD sharded
    across a device mesh): mesh= block-sharding per plane, devices= plane-level
    round-robin across chips."""

    KW = dict(
        frame_range=280, max_components=4, background_rank=1,
        temporal_avg_factor=4, sim_iters=15, seed=0,
    )

    def test_devices_round_robin_matches_sequential(self):
        import jax

        planes = volumetric_stack(n_planes=3, d1=20, d2=20, t=280, seed=11)
        seq = volumetric_decomposition(planes, (10, 10), **self.KW)
        par = volumetric_decomposition(
            planes, (10, 10), devices=jax.devices()[:2], **self.KW
        )
        assert par.shape == seq.shape
        for z in range(3):
            a = seq.planes[z][:, :, :]
            b = par.planes[z][:, :, :]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    def test_mesh_forwarding(self):
        from localmd_tpu.parallel.mesh import make_mesh

        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=12)
        seq = volumetric_decomposition(planes, (10, 10), **self.KW)
        vol = volumetric_decomposition(
            planes, (10, 10), mesh=make_mesh(2), **self.KW
        )
        assert vol.shape == (280, 2, 20, 20)
        for z in range(2):
            np.testing.assert_allclose(
                seq.planes[z][:, :, :], vol.planes[z][:, :, :],
                rtol=1e-4, atol=1e-4,
            )

    def test_devices_and_mesh_mutually_exclusive(self):
        import jax

        from localmd_tpu.parallel.mesh import make_mesh

        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=13)
        with pytest.raises(ValueError, match="mutually exclusive"):
            volumetric_decomposition(
                planes, (10, 10), devices=jax.devices()[:2],
                mesh=make_mesh(2), **self.KW
            )

    def test_per_plane_checkpoints(self, tmp_path):
        import os

        # Planes with DIFFERENT content but identical shape/config: a shared
        # checkpoint path would make plane 1 "resume" from plane 0's stages
        # (the resume fingerprint covers config, not data).
        planes = volumetric_stack(n_planes=2, d1=20, d2=20, t=280, seed=14)
        ck = str(tmp_path / "vol_ck")
        vol = volumetric_decomposition(planes, (10, 10), checkpoint_path=ck, **self.KW)
        assert os.path.exists(f"{ck}_plane0.stats.npz")
        assert os.path.exists(f"{ck}_plane1.stats.npz")
        # plane results reflect their own data, not plane 0's
        ref = volumetric_decomposition(planes, (10, 10), **self.KW)
        for z in range(2):
            np.testing.assert_allclose(
                vol.planes[z][:, :, :], ref.planes[z][:, :, :],
                rtol=1e-5, atol=1e-5,
            )

    def test_grid_constants_per_device(self):
        import jax

        from localmd_tpu.ops.tiling import BlockGrid

        grid = BlockGrid(20, 20, (10, 10), "F")
        devs = jax.devices()
        with jax.default_device(devs[0]):
            w0, _, _, _ = grid.device_constants()
        with jax.default_device(devs[1]):
            w1, _, _, _ = grid.device_constants()
        assert list(w0.devices())[0] == devs[0]
        assert list(w1.devices())[0] == devs[1]
        np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
