"""Smoke test of the PMD pipeline on one NVIDIA GPU.

Run from the repository root::

    python chip_smoke.py               # one card: phases (a)-(d)
    python chip_smoke.py --four-cards  # four cards: mesh + plane-parallel only

One process drives the card(s); movies are generated on the device from a
seed with ``localmd_tpu.sim``. Each phase prints one line; the last line is a
JSON object ``{"ok": true, "device": {...}}``. Any failed check, a non-GPU
device, or a background-compile error exits non-zero without that line.

Phases (one card):
  (a) device: platform, kind, count, ``nvidia-smi`` name and power limit,
      JAX/jaxlib versions, XLA_FLAGS.
  (b) the plain-XLA paths that serve the statistics pass, the V regression
      and reconstruction, each at real width against an independent
      float64 / host reference.
  (c) ``localmd_decomposition`` on a 512x512x2048 two-photon movie with the
      benchmark's arguments: cold and warm time, rank, error against the
      clean movie, agreement with a ``matmul_precision="highest"`` run,
      peak device memory, and that warm runs trace and compile nothing.
  (d) a uint16 voltage-imaging movie (256x256x8192, 20x20 blocks,
      multi-window): the gather block path and the dense-projector V
      regression, with its own ``matmul_precision="highest"`` run.

Four cards: the (c) configuration with ``mesh=make_mesh(4)`` against the
one-card run (two warm mesh runs, which must trace and compile nothing),
and four planes with ``volumetric_decomposition(devices=...)``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# the benchmark configuration (bench.py run_once): 512^2 two-photon FOV,
# 32x32 blocks, reference demo settings
BENCH_KW = dict(
    frame_range=1024, max_components=20, background_rank=15,
    temporal_avg_factor=10, sim_iters=250, seed=0, block_batch_size=256,
    rank_prune=True,
)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def require_gpu(devices) -> dict:
    """The device record of a GPU run; refuses any other platform."""
    if not devices:
        raise CheckFailed("JAX reports no devices")
    dev = devices[0]
    if dev.platform != "gpu":
        raise CheckFailed(
            f"chip_smoke needs a GPU; JAX's first device is {dev.platform!r}"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


TRACE_EVENT = "/jax/core/compile/jaxpr_trace_duration"
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


@contextlib.contextmanager
def count_compiles():
    """Counts the programs JAX traces and compiles inside the block (a hit
    in the persistent compile cache still counts as a trace)."""
    import jax

    counts = {"traces": 0, "compiles": 0}

    def listen(event, duration_secs, **kwargs):
        if event == TRACE_EVENT:
            counts["traces"] += 1
        elif event == COMPILE_EVENT:
            counts["compiles"] += 1

    jax.monitoring.register_event_duration_secs_listener(listen)
    try:
        yield counts
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _welch_sigma_f64(x: np.ndarray) -> np.ndarray:
    """Reference noise sigma of (T, P) traces: scipy Welch (nperseg 256,
    noverlap 128, Hann, constant detrend, one-sided density) in float64,
    mean of bins [65, 129) x 0.5, square root (reference
    preprocessing_utils.py:28-37)."""
    from scipy.signal import welch

    _, psd = welch(x, nperseg=256, noverlap=128, axis=0)
    return np.sqrt(np.mean(psd[65:129] * 0.5, axis=0))


def phase_stats(d1=512, d2=512, t=1024, seed=0) -> None:
    from localmd_tpu.loader import _to_fov_f32
    from localmd_tpu.ops.noise import get_mean_and_noise
    from localmd_tpu.sim import two_photon_movie

    raw = two_photon_movie(d1, d2, t, seed=seed)           # (t, d1, d2) f32
    m, sig = get_mean_and_noise(_to_fov_f32(raw), t)
    m, sig = np.asarray(m), np.asarray(sig)
    x = np.asarray(raw, np.float64).reshape(t, d1 * d2)
    want_m = x.mean(axis=0).reshape(d1, d2)
    want_s = np.concatenate([
        _welch_sigma_f64(x[:, s:s + 32768])
        for s in range(0, d1 * d2, 32768)
    ]).reshape(d1, d2)
    err_m = float(np.max(np.abs(m - want_m) / np.abs(want_m)))
    err_s = float(np.max(np.abs(sig - want_s) / want_s))
    # The Welch DFT matmuls run at Precision.HIGHEST (full f32); f32
    # accumulation over 1024 frames / 256-sample segments leaves ~1e-6
    # relative error, so 1e-4 (elementwise, max over all pixels) is loose
    # enough for summation-order noise and tight enough to catch TF32 (~1e-3).
    tol = 1e-4
    emit("b.stats", shape=[t, d1, d2], dtype="float32",
         max_rel_err_mean=err_m, max_rel_err_sigma=err_s, tol=tol,
         reference="scipy.signal.welch float64", precision="HIGHEST (f32)")
    check(err_m <= tol and err_s <= tol, "stats pass vs scipy Welch")


def phase_vproj(d1=512, d2=512, t=1024, r=320, seed=1) -> None:
    import jax
    import jax.numpy as jnp

    from localmd_tpu.loader import _v_projection_kernel

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    raw = jax.random.randint(k1, (t, d1, d2), 0, 4096).astype(jnp.uint16)
    a = jax.random.normal(k2, (d1 * d2, r), jnp.float32) * 1e-3
    c = jax.random.normal(k3, (r,), jnp.float32)
    got = np.asarray(_v_projection_kernel(a, c, raw, "F"))
    flat = np.asarray(raw).transpose(1, 2, 0).reshape(d1 * d2, t, order="F")
    want = np.asarray(a, np.float64).T @ flat.astype(np.float64)
    want -= np.asarray(c, np.float64)[:, None]
    err = rel_err(got, want)
    # Default matmul precision: on this card an f32 product may run in
    # TF32 (10-bit mantissa, unit roundoff 2^-11 ~ 4.9e-4 per operand);
    # random-sign rounding over 262144-term sums keeps the relative
    # Frobenius error near that roundoff, so 2e-3 bounds it with margin.
    tol = 2e-3
    emit("b.vproj", raw=[t, d1, d2], raw_dtype="uint16", rank=r,
         rel_frobenius_err=err, tol=tol, reference="numpy float64",
         precision="default (TF32 allowed)")
    check(err <= tol, "V projection vs numpy float64")


def _signal(pmd, frames, mean_off):
    """Reconstructed frames minus a known offset, as float64 host array."""
    return np.asarray(pmd.reconstruct_frames(frames), np.float64) - mean_off


def phase_pipeline(d1=512, d2=512, t=2048, seed=0):
    import jax

    import localmd_tpu
    from localmd_tpu.sim import two_photon_movie

    movie = two_photon_movie(d1, d2, t, seed=seed)
    clean = two_photon_movie(d1, d2, t, noise_sigma=0.0, seed=seed)
    frames = np.arange(0, t, t // 64)[:64]

    def run(**kw):
        t0 = time.perf_counter()
        pmd = localmd_tpu.localmd_decomposition(movie, (32, 32), **BENCH_KW, **kw)
        pmd.block_until_ready()
        return pmd, time.perf_counter() - t0

    pmd, cold = run()
    warm_times = []
    with count_compiles() as warm_counts:
        for _ in range(3):
            pmd, w = run()
            warm_times.append(w)
    errs = pmd.pipeline_warm["errors"]
    check(not errs, f"background compile errors: {errs}")

    offset = 100.0  # two_photon_movie's camera offset
    clean_f = np.asarray(clean[frames], np.float64) - offset
    noisy_f = np.asarray(movie[frames], np.float64) - offset
    rec = _signal(pmd, frames, offset)
    check(np.all(np.isfinite(rec)) and rec.shape == (64, d1, d2),
          "reconstruction finite with shape (64, d1, d2)")
    err_clean = rel_err(rec, clean_f)
    # denoising: the reconstruction must be closer to the clean movie than
    # the noisy input is
    noise_ratio = float(np.linalg.norm(rec - clean_f)
                        / np.linalg.norm(noisy_f - clean_f))

    hi, hi_t = run(matmul_precision="highest")
    rec_hi = _signal(hi, frames, offset)
    agree = rel_err(rec, rec_hi)
    err_clean_hi = rel_err(rec_hi, clean_f)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    emit("c.pipeline", movie=[t, d1, d2], blocks=[32, 32],
         cold_s=cold, warm_s=warm_times, rank=pmd.rank,
         ranks=pmd.pipeline_ranks, warm_traces=warm_counts["traces"],
         warm_compiles=warm_counts["compiles"], rel_err_vs_clean=err_clean,
         noise_ratio=noise_ratio, highest_rank=hi.rank,
         highest_ranks=hi.pipeline_ranks, highest_s=hi_t,
         rel_err_vs_clean_highest=err_clean_hi,
         rel_diff_default_vs_highest=agree, peak_bytes_in_use=peak,
         timings=pmd.pipeline_timings)
    check(pmd.rank > 0, "nonzero rank")
    check(noise_ratio < 0.5, "reconstruction removes at least half the noise")
    check(warm_counts["traces"] == 0 and warm_counts["compiles"] == 0,
          f"warm runs traced or compiled programs: {warm_counts}")
    # The default-precision run may use TF32 matmuls. On the H100 that moves
    # per-block rank decisions that sit on a threshold: the blockwise rank
    # was 16783 at default against 16795 at "highest", with the same final
    # rank 336 (ranks / highest_ranks above). Each flip adds or drops one
    # weak component; 5e-2 of the signal norm bounds that, and the
    # clean-movie errors of the two runs must agree to 1e-2.
    check(agree <= 5e-2, "default vs highest precision reconstructions")
    check(abs(err_clean - err_clean_hi) <= 1e-2,
          "default and highest precision equally close to the clean movie")
    return pmd, frames


def phase_reconstruct(pmd, frames) -> None:
    got = np.asarray(pmd.reconstruct_frames(frames), np.float64)
    want = np.asarray(
        pmd._getitem_host((frames, slice(None), slice(None))), np.float64
    )
    mean = np.asarray(pmd.mean_img, np.float64)
    err = rel_err(got - mean, want - mean)
    # U @ temporal runs at default precision (TF32 allowed) on the device;
    # the host reference is a float32 scipy CSR product. 2e-3 of the
    # mean-subtracted signal bounds TF32 roundoff (see b.vproj).
    tol = 2e-3
    emit("b.reconstruct", frames=len(frames), rel_frobenius_err=err, tol=tol,
         reference="host CSR (_getitem_host), float32",
         precision="default (TF32 allowed)")
    check(err <= tol, "reconstruct_frames vs host CSR")


def phase_voltage(d1=256, d2=256, t=8192, seed=0) -> None:
    import jax.numpy as jnp

    import localmd_tpu
    from localmd_tpu.sim import voltage_movie

    scale, offset = 10.0, 500.0  # voltage_movie offset 50, x10 before rounding
    movie = voltage_movie(d1, d2, t, seed=seed)
    movie_u16 = jnp.clip(jnp.round(movie * scale), 0, 65535).astype(jnp.uint16)
    del movie
    kw = dict(frame_range=4000, window_chunks=2000, max_components=20,
              background_rank=15, temporal_avg_factor=10, sim_iters=250,
              seed=0)

    def run(**extra):
        t0 = time.perf_counter()
        pmd = localmd_tpu.localmd_decomposition(movie_u16, (20, 20), **kw,
                                                **extra)
        pmd.block_until_ready()
        return pmd, time.perf_counter() - t0

    pmd, cold = run()
    pmd, warm = run()
    check(not pmd.pipeline_warm["errors"], "background compile errors")
    hi, hi_t = run(matmul_precision="highest")

    frames = np.arange(0, t, t // 64)[:64]
    clean = voltage_movie(d1, d2, t, noise_sigma=0.0, seed=seed)
    clean_f = np.asarray(clean[frames], np.float64) * scale - offset
    noisy_f = np.asarray(movie_u16[frames], np.float64) - offset
    rec = _signal(pmd, frames, offset)
    rec_hi = _signal(hi, frames, offset)
    check(np.all(np.isfinite(rec)) and rec.shape == (64, d1, d2),
          "voltage reconstruction finite with shape (64, d1, d2)")
    noise_ratio = float(np.linalg.norm(rec - clean_f)
                        / np.linalg.norm(noisy_f - clean_f))
    err_clean = rel_err(rec, clean_f)
    err_clean_hi = rel_err(rec_hi, clean_f)
    agree = rel_err(rec, rec_hi)
    emit("d.voltage_u16", movie=[t, d1, d2], blocks=[20, 20],
         window_chunks=2000, cold_s=cold, warm_s=warm, rank=pmd.rank,
         ranks=pmd.pipeline_ranks, rel_err_vs_clean=err_clean,
         noise_ratio=noise_ratio, highest_rank=hi.rank,
         highest_ranks=hi.pipeline_ranks, highest_s=hi_t,
         rel_err_vs_clean_highest=err_clean_hi,
         rel_diff_default_vs_highest=agree, timings=pmd.pipeline_timings)
    check(pmd.rank > 0, "voltage: nonzero rank")
    check(noise_ratio < 0.5, "voltage: removes at least half the noise")
    # As in phase (c): TF32 at default precision may flip threshold-close
    # block rank decisions; the bound and its reason are the same.
    check(agree <= 5e-2, "voltage: default vs highest precision")
    check(abs(err_clean - err_clean_hi) <= 1e-2,
          "voltage: default and highest precision equally close to clean")


def phase_four_cards(devices, d=512, t=2048, plane=256, plane_t=1024,
                     seed=0) -> None:
    """Block-sharded mesh run against the one-card run, and plane-parallel
    volumetric decomposition with one plane per card."""
    import localmd_tpu
    from localmd_tpu.parallel.mesh import make_mesh
    from localmd_tpu.sim import two_photon_movie, volumetric_stack
    from localmd_tpu.volumetric import volumetric_decomposition

    check(len(devices) >= 4, f"--four-cards needs 4 devices, found {len(devices)}")
    d1 = d2 = d
    movie = two_photon_movie(d1, d2, t, seed=seed)
    frames = np.arange(0, t, t // 64)[:64]

    def run(**kw):
        t0 = time.perf_counter()
        pmd = localmd_tpu.localmd_decomposition(movie, (32, 32), **BENCH_KW, **kw)
        pmd.block_until_ready()
        return pmd, time.perf_counter() - t0

    one, one_cold = run()
    one, one_warm = run()
    mesh = make_mesh(4)
    four, four_cold = run(mesh=mesh)
    four_warm, warm_counts = [], []
    for _ in range(2):
        with count_compiles() as counts:
            four, w = run(mesh=mesh)
        four_warm.append(w)
        warm_counts.append(counts)
    rec1 = _signal(one, frames, 100.0)
    rec4 = _signal(four, frames, 100.0)
    check(np.all(np.isfinite(rec4)), "mesh reconstruction finite")
    diff = rel_err(rec4, rec1)
    emit("four.mesh", devices=4, cold_s=four_cold, warm_s=four_warm,
         warm_counts=warm_counts, one_card_cold_s=one_cold,
         one_card_warm_s=one_warm, rank=four.rank, one_card_rank=one.rank,
         rel_diff_vs_one_card=diff)
    check(all(c["traces"] == 0 and c["compiles"] == 0 for c in warm_counts),
          f"warm mesh runs traced or compiled programs: {warm_counts}")
    # the mesh run takes the psum'd canvas Gram and the frame-sharded dense
    # V projection (the one-card run may take the banded Gram and the cell
    # V projection): same math, other summation order and TF32 roundoff,
    # so the bound is the precision agreement bound of phase (c)
    check(diff <= 5e-2, "mesh vs one-card reconstruction")

    planes = volumetric_stack(n_planes=4, d1=plane, d2=plane, t=plane_t,
                              seed=3)
    kw = dict(max_components=20, background_rank=15, temporal_avg_factor=10,
              sim_iters=250, seed=0)
    t0 = time.perf_counter()
    vol = volumetric_decomposition(planes, (32, 32), frame_range=plane_t,
                                   devices=devices[:4], **kw)
    for p in vol.planes:
        p.block_until_ready()
    vol_s = time.perf_counter() - t0
    homes = [next(iter(p._blocksparse.panels.devices())) for p in vol.planes]
    ref = localmd_tpu.localmd_decomposition(planes[1], (32, 32),
                                            frame_range=plane_t, **kw)
    fr = np.arange(0, plane_t, plane_t // 64)
    diff_v = rel_err(_signal(vol.planes[1], fr, 100.0), _signal(ref, fr, 100.0))
    emit("four.volumetric", planes=4, plane_shape=[plane_t, plane, plane],
         wall_s=vol_s, plane_devices=[str(h) for h in homes],
         rel_diff_plane1_vs_sequential=diff_v)
    check([h.id for h in homes] == [d.id for d in devices[:4]],
          "each plane on its own card")
    # same program, same seed, other card: equal up to run-to-run
    # nondeterminism of GPU reductions, which can move a rank decision that
    # sits on a threshold (the bound of phase (c))
    check(diff_v <= 5e-2, "plane-parallel vs sequential plane")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases (mesh, devices=)")
    args = ap.parse_args(argv)

    import jax

    record = require_gpu(jax.devices())
    import jaxlib

    from localmd_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    smi = nvidia_smi_line()
    emit("a.device", **record, jax=jax.__version__, jaxlib=jaxlib.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache_dir)
    print(smi, flush=True)  # card name and power limit, as nvidia-smi says

    if args.four_cards:
        phase_four_cards(jax.devices())
    else:
        phase_stats()
        phase_vproj()
        pmd, frames = phase_pipeline()
        phase_reconstruct(pmd, frames)
        del pmd
        phase_voltage()
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
