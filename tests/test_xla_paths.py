"""The plain-XLA paths that serve the statistics pass, the V regression and
reconstruction on every backend, each against an independent float64 /
per-block numpy reference; the backend fast-path table; the compile-cache
location; and chip_smoke's refusal of a non-GPU device."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from localmd_tpu.loader import _to_fov_f32, _v_projection_kernel
from localmd_tpu.ops.noise import (
    get_mean_and_noise,
    get_mean_and_noise_ref_compat,
    get_mean_chunk,
)


def _welch_sigma_f64(x, nperseg):
    """Reference noise sigma of (T, P) traces: scipy Welch in float64,
    mean of one-sided density bins [65, 129) x 0.5, square root."""
    _, psd = scipy.signal.welch(x, nperseg=nperseg, noverlap=128, axis=0)
    return np.sqrt(np.mean(psd[65:129] * 0.5, axis=0))


# (t, d1, d2, dtype, mode): mode "scipy" = documented 256-sample Welch,
# "reference" = one full-chunk periodogram (welch_compat="reference"),
# "mean" = short chunk, mean only
STATS_CASES = [
    (512, 16, 32, "float32", "scipy"),
    (384, 16, 32, "uint16", "scipy"),
    (512, 25, 28, "float32", "scipy"),      # 700 pixels: no tile alignment
    (300, 20, 30, "float32", "reference"),
    (100, 16, 32, "float32", "mean"),
]


@pytest.mark.parametrize("t,d1,d2,dtype,mode", STATS_CASES)
def test_stats_step_matches_scipy_welch_f64(rng, t, d1, d2, dtype, mode):
    if dtype == "uint16":
        raw = rng.integers(0, 5000, size=(t, d1, d2), dtype=np.uint16)
    else:
        raw = (rng.standard_normal((t, d1, d2)) * 2.3 + 1.0).astype(np.float32)
    total = 10_000
    chunk = _to_fov_f32(jnp.asarray(raw))
    x = raw.astype(np.float64).reshape(t, d1 * d2)
    want_mean = (x.sum(axis=0) / total).reshape(d1, d2)
    if mode == "mean":
        mean = get_mean_chunk(chunk, total)
    else:
        fn = get_mean_and_noise_ref_compat if mode == "reference" else get_mean_and_noise
        mean, sigma = fn(chunk, total)
        nperseg = t if mode == "reference" else 256
        want_sigma = _welch_sigma_f64(x, nperseg).reshape(d1, d2)
        np.testing.assert_allclose(np.asarray(sigma), want_sigma, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(mean), want_mean, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize(
    "t,d1,d2,r,dtype,order",
    [
        (100, 28, 25, 37, "uint16", "F"),
        (256, 16, 32, 128, "float32", "C"),
        (64, 32, 32, 2560, "float32", "F"),
    ],
)
def test_v_projection_matches_numpy_f64(rng, t, d1, d2, r, dtype, order):
    if dtype == "uint16":
        raw = rng.integers(0, 4000, size=(t, d1, d2)).astype(np.uint16)
    else:
        raw = rng.standard_normal((t, d1, d2)).astype(np.float32)
    a = (rng.standard_normal((d1 * d2, r)) * 0.01).astype(np.float32)
    c = rng.standard_normal(r).astype(np.float32)
    got = np.asarray(
        _v_projection_kernel(jnp.asarray(a), jnp.asarray(c), jnp.asarray(raw), order)
    )
    flat = raw.astype(np.float64).transpose(1, 2, 0).reshape(d1 * d2, t, order=order)
    want = a.astype(np.float64).T @ flat - c.astype(np.float64)[:, None]
    assert got.shape == (r, t)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize(
    "d1,d2,b,slots,f,k_bg",
    [(24, 16, 8, 3, 8, 0), (60, 52, 20, 3, 4, 2), (100, 100, 32, 2, 4, 1)],
)
def test_reconstruct_standardized_matches_blockwise_overlap_add(
    rng, d1, d2, b, slots, f, k_bg
):
    from localmd_tpu.blocksparse import BlockSparseMatrix
    from localmd_tpu.ops.tiling import BlockGrid
    from localmd_tpu.pmd_array import PMDArray

    grid = BlockGrid(d1, d2, (b, b))
    n, p = grid.n_blocks, grid.pixels_per_block
    panels = rng.standard_normal((n, p, slots)).astype(np.float32)
    bg = rng.standard_normal((d1 * d2, k_bg)).astype(np.float32)
    r_cols = n * slots + k_bg
    temporal = rng.standard_normal((r_cols, f)).astype(np.float32)
    u = BlockSparseMatrix(
        panels=jnp.asarray(panels), rows=jnp.asarray(grid.rows),
        n_pixels=d1 * d2, dense_basis=jnp.asarray(bg),
        starts=jnp.asarray(grid.starts), block_shape=(b, b),
        coset_info=grid.coset_info(), cell_geom=grid.cell_geometry(),
    )
    pmd = PMDArray(
        u, np.eye(r_cols, dtype=np.float32), np.ones(r_cols, np.float32),
        np.zeros((r_cols, f), np.float32), (f, d1, d2), "F",
        np.zeros((d1, d2), np.float32), np.ones((d1, d2), np.float32),
        counts=np.full(n, slots),
    )
    got = np.asarray(pmd._reconstruct_standardized(jnp.asarray(temporal)))

    # per-block numpy overlap-add in float64, F-order global pixel ids
    want = np.zeros((d1 * d2, f))
    tb = temporal.astype(np.float64)
    for k in range(n):
        want[grid.rows[k]] += panels[k].astype(np.float64) @ tb[k * slots:(k + 1) * slots]
    want += bg.astype(np.float64) @ tb[n * slots:]
    want = want.reshape(d1, d2, f, order="F")
    assert got.shape == (d1, d2, f)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- backend fast-path table ---------------------------------------------------


def test_cpu_row_keeps_every_plain_path():
    from localmd_tpu import capabilities
    from localmd_tpu.blocksparse import _banded_gram_enabled, _coset_vproj_enabled

    assert jax.default_backend() == "cpu"
    assert capabilities.FAST_PATHS["cpu"] == {
        "banded_gram": False, "coset_vproj": False, "aot_warm": False,
    }
    assert set(capabilities.FAST_PATHS) == {"cpu", "gpu"}
    assert set(capabilities.FAST_PATHS["gpu"]) == set(capabilities.FAST_PATHS["cpu"])
    assert not _banded_gram_enabled() and not _coset_vproj_enabled()
    assert capabilities.resolve(True, "banded_gram") is True
    assert capabilities.resolve(False, "aot_warm") is False
    with pytest.raises(ValueError):
        capabilities.resolve("yes", "banded_gram")


def test_unknown_platform_is_an_error(monkeypatch):
    from localmd_tpu import capabilities

    monkeypatch.setattr(capabilities.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no fast-path table row"):
        capabilities.fast_path("banded_gram")
    with pytest.raises(RuntimeError):
        capabilities.resolve("auto", "coset_vproj")
    # a forced flag never consults the table
    assert capabilities.resolve(True, "banded_gram") is True


def test_gpu_row_reads_through_module_flags(monkeypatch):
    from localmd_tpu import blocksparse, capabilities

    monkeypatch.setattr(capabilities.jax, "default_backend", lambda: "gpu")
    row = capabilities.FAST_PATHS["gpu"]
    assert blocksparse._banded_gram_enabled() is row["banded_gram"]
    assert blocksparse._coset_vproj_enabled() is row["coset_vproj"]
    monkeypatch.setattr(blocksparse, "BANDED_GRAM", not row["banded_gram"])
    monkeypatch.setattr(blocksparse, "COSET_VPROJ", not row["coset_vproj"])
    assert blocksparse._banded_gram_enabled() is not row["banded_gram"]
    assert blocksparse._coset_vproj_enabled() is not row["coset_vproj"]


# -- compile cache ---------------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch):
    from localmd_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from localmd_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(checkout, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- chip_smoke device check -----------------------------------------------------


def test_chip_smoke_refuses_cpu_device():
    import chip_smoke

    with pytest.raises(chip_smoke.CheckFailed, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.require_gpu([])

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    assert chip_smoke.require_gpu([FakeGpu()] * 4) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }


@pytest.mark.gpu
def test_pipeline_on_card_uses_gpu_row():
    """On a GPU: the table row resolves and a small pipeline run through it
    returns finite factors (run with ``JAX_PLATFORMS=cuda``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")
    import localmd_tpu
    from localmd_tpu import capabilities
    from localmd_tpu.sim import two_photon_movie

    for name in capabilities.FAST_PATHS["gpu"]:
        capabilities.fast_path(name)
    movie = two_photon_movie(128, 128, 1100, seed=0)
    pmd = localmd_tpu.localmd_decomposition(
        movie, (32, 32), frame_range=1024, max_components=10,
        background_rank=4, sim_iters=50, seed=0,
    ).block_until_ready()
    rec = np.asarray(pmd.reconstruct_frames(np.arange(8)))
    assert pmd.rank > 0 and np.all(np.isfinite(rec))
