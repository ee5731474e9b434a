"""Benchmark: PMD decomposition throughput on one GPU.

Metric (BASELINE.json): Mpixel-frames/sec/chip at 512x512 FOV — total movie
pixel-frames (d1*d2*T) divided by end-to-end pipeline wall time (statistics
pass + init + blockwise decomposition + factorized SVD + streaming V
regression), ended by ``block_until_ready`` on the returned factors.

Prints ONE JSON line. Runs the pipeline once cold and five times warm and
reports the best warm run. Refuses to run without a GPU: a number from any
other backend is not a device measurement.
"""

import json
import os
import time


def make_movie(d1=512, d2=512, t=2048, rank=16, seed=0, dtype="float32"):
    """Synthetic low-rank + noise movie generated ON DEVICE, so the
    benchmark measures decomposition throughput, not host->device IO.
    dtype="uint16" emits a photon-count-like scanner movie at half the
    device memory of float32."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    spatial = jax.random.normal(k1, (d1 * d2, rank), dtype=jnp.float32)
    if dtype == "float32":
        temporal = jax.random.normal(k2, (rank, t), dtype=jnp.float32)
        movie = (spatial @ temporal).T.reshape(t, d1, d2)
        movie = movie + jax.random.normal(k3, (t, d1, d2), dtype=jnp.float32)
        return jax.block_until_ready(movie)

    # integer movies are generated CHUNKED: the full-movie f32 intermediate
    # of the one-shot path is 4 bytes/px-frame (16 GiB at 1024^2 x 4096);
    # per-chunk transients + the donated integer buffer stay small
    from functools import partial

    @partial(jax.jit, donate_argnums=(0,), static_argnums=(5,))
    def _fill(out, sp, kt, kn, s0, n):
        te = jax.random.normal(kt, (sp.shape[1], n), dtype=jnp.float32)
        chunk = (sp @ te).T.reshape(n, out.shape[1], out.shape[2])
        chunk = chunk + jax.random.normal(kn, chunk.shape, dtype=jnp.float32)
        chunk = jnp.clip(chunk * 40.0 + 1000.0, 0, 65535).astype(out.dtype)
        return jax.lax.dynamic_update_slice(out, chunk, (s0, 0, 0))

    step = min(512, t)
    out = jnp.zeros((t, d1, d2), dtype=dtype)
    for i, s0 in enumerate(range(0, t, step)):
        # tail remainder gets its own (one extra) compiled variant rather
        # than falling back to a whole-movie chunk
        n = min(step, t - s0)
        kt = jax.random.fold_in(k2, i)
        kn = jax.random.fold_in(k3, i)
        out = _fill(out, spatial, kt, kn, jnp.int32(s0), n)
    return jax.block_until_ready(out)


def run_once(movie, quiet=True, matmul_precision=None, blocks=(32, 32),
             frame_range=1024, block_batch_size=256):
    import logging

    import localmd_tpu

    if quiet:
        logging.getLogger("localmd_tpu").setLevel(logging.WARNING)
    t0 = time.perf_counter()
    pmd = localmd_tpu.localmd_decomposition(
        movie,
        blocks,
        frame_range=frame_range,
        max_components=20,
        background_rank=15,
        temporal_avg_factor=10,
        sim_iters=250,
        seed=0,
        block_batch_size=block_batch_size,
        rank_prune=True,  # reference demo config (official_demo.ipynb cell 4)
        matmul_precision=matmul_precision,
    ).block_until_ready()
    elapsed = time.perf_counter() - t0
    return pmd, elapsed


# Published peaks by device kind (NVIDIA H100 SXM data sheet: dense rates
# without sparsity, at the full 700 W power limit). A device that is not in
# the table is an error, not a default.
PEAKS = {
    "H100": {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
             "fp32_tflops": 67.0, "hbm_tb_s": 3.35},
}


def chip_peaks(device_kind: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in device_kind:
            return peaks
    raise KeyError(f"no published peaks for device kind {device_kind!r}")


def estimate_pipeline_flops(
    d1, d2, t, frame_range, block, max_components, background_rank,
    temporal_avg_factor, spatial_avg_factor, sim_iters, rank_prune,
    rank_prune_factor, ranks,
):
    """Model matmul FLOPs (2*m*n*k per product) of one pipeline run.

    Counts the dominant countable products per stage — Welch DFT, background
    rSVD, init background projection, threshold Monte-Carlo, per-block
    two-stage kernels, Gram quadratic + eigh, streaming V regression, final
    reformat. Elementwise traffic and small QR/SVD tails are excluded, so
    treat as a ~±20% model, good enough to place the run on the roofline.
    ``ranks`` is the pipeline's reported rank dict (pipeline_ranks).
    """
    from localmd_tpu.ops.tiling import BlockGrid

    d = d1 * d2
    b1 = b2 = block
    fl = 0.0

    # stats pass: batched Welch partial-DFT (2 matmuls x 7 segments x 64 bins)
    n_chunks = (t + 1023) // 1024
    fl += n_chunks * d * 2 * (2 * 7 * 256 * 64)
    # background rSVD over min(1000, t) standardized frames
    k_bg_sk = background_rank + 10
    n_bg = min(1000, t)
    fl += 2 * d * n_bg * k_bg_sk * 2 + 2 * d * k_bg_sk * k_bg_sk
    # init frames: standardize + project out background (2 products)
    fl += 2 * d * background_rank * frame_range * 2
    # threshold Monte-Carlo: sim_iters rSVDs on (b1*b2, binned window)
    p = b1 * b2
    t_bin = frame_range // temporal_avg_factor
    fl += sim_iters * 2 * p * t_bin * (1 + 10) * 2

    # block stage
    grid = BlockGrid(d1, d2, (b1, b2))
    nb = grid.n_blocks
    p_c = -(-b1 // spatial_avg_factor) * -(-b2 // spatial_avg_factor)
    t_b = t_bin * temporal_avg_factor
    mc = max_components
    per_block = (
        2 * p_c * t_bin * (mc + 10) * 2      # coarse sketch + QtX
        + 2 * p_c * (mc + 10) * t_b          # coarse temporal projection
        + 2 * p * t_b * mc                   # full-res spatial projection
        + 2 * p * mc * t_b * 2               # v_new + temporal projector
    )
    fl += nb * per_block

    # factorized SVD
    m = ranks["pre_reduction"]
    nnz = nb * p * mc + d * background_rank  # blocked-sparse U entries
    if rank_prune:
        cols = max(1, int(min(m, frame_range) * rank_prune_factor))
        fl += 2 * m * frame_range * cols     # random projection of V
    else:
        cols = frame_range
    r_cols = min(m, cols)
    fl += 2 * nnz * r_cols                   # Z = U @ right
    fl += 2 * d * r_cols * r_cols            # quad = Z^T Z
    fl += 10 * r_cols ** 3                   # eigh (rough)
    fl += 2 * m * r_cols * r_cols            # P = right @ eigvecs / s

    # streaming V regression over the FULL movie
    r_red = ranks["reduced"]
    fl += 2 * nnz * r_red                    # A = U @ P
    fl += 2 * d * r_red * t                  # chunked A~^T X
    # final reformat (Gram trick on (r_red, t))
    fl += 2 * r_red * r_red * t + 10 * r_red ** 3
    return fl


def _stage_stats(timing_dicts):
    """Per-stage median + IQR over the warm runs: {stage: {median_s, iqr_s}}."""
    stats = {}
    for d in timing_dicts:
        for k, v in d.items():
            stats.setdefault(k, []).append(float(v))
    out = {}
    for k, vals in stats.items():
        v = sorted(vals)
        n = len(v)
        med = v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])
        q1 = v[max(0, int(0.25 * (n - 1)))]
        q3 = v[min(n - 1, int(round(0.75 * (n - 1))))]
        out[k] = {"median_s": round(med, 4), "iqr_s": round(q3 - q1, 4)}
    return out


def main():
    import jax

    from localmd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, found {dev.platform!r}")
    peaks = chip_peaks(dev.device_kind)

    d1 = d2 = 512
    t = int(os.environ.get("BENCH_FRAMES", "2048"))
    movie = make_movie(d1, d2, t)

    _, cold = run_once(movie)
    warms = []
    stage_timings = []
    pmd = None
    for _ in range(5):
        pmd, w = run_once(movie)
        warms.append(w)
        stage_timings.append(dict(getattr(pmd, "pipeline_timings", {}) or {}))
    warm = min(warms)
    median = sorted(warms)[len(warms) // 2]

    hi_mpfs = None
    if os.environ.get("BENCH_HIGHEST"):
        # opt-in comparison leg: how much full-f32 matmuls cost
        _, _ = run_once(movie, matmul_precision="highest")  # compile
        hi_warms = []
        for _ in range(3):
            _, w = run_once(movie, matmul_precision="highest")
            hi_warms.append(w)
        hi_mpfs = d1 * d2 * t / min(hi_warms) / 1e6

    pixel_frames = d1 * d2 * t
    mpfs = pixel_frames / warm / 1e6
    baseline_per_chip = 125.0  # BASELINE.json north star, per chip

    # -- second leg: 1024^2 x 4096 uint16, device-resident (8.6 GB) ----------
    big_leg = None
    if not os.environ.get("BENCH_SKIP_BIG"):
        del movie
        big = make_movie(1024, 1024, 4096, dtype="uint16")
        big_kw = dict(blocks=(40, 40), frame_range=512, block_batch_size=64)
        _, big_cold = run_once(big, **big_kw)
        big_warms = []
        big_pmd = None
        for _ in range(3):
            big_pmd, w = run_once(big, **big_kw)
            big_warms.append(w)
        big_warm = min(big_warms)
        big_leg = {
            "warm_s": round(big_warm, 2),
            "cold_s": round(big_cold, 2),
            "mpf_s": round(1024 * 1024 * 4096 / big_warm / 1e6, 1),
            "final_rank": big_pmd.rank,
        }
        del big, big_pmd

    flops = estimate_pipeline_flops(
        d1, d2, t, frame_range=1024, block=32, max_components=20,
        background_rank=15, temporal_avg_factor=10, spatial_avg_factor=2,
        sim_iters=250, rank_prune=True, rank_prune_factor=0.33,
        ranks=pmd.pipeline_ranks,
    )
    tflops = flops / warm / 1e12
    print(
        json.dumps(
            {
                "metric": "Mpixel-frames/sec/chip at 512x512 FOV",
                "value": round(mpfs, 2),
                "unit": "Mpf/s",
                "vs_baseline": round(mpfs / baseline_per_chip, 4),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "detail": {
                    "warm_s": round(warm, 4),
                    "median_s": round(median, 4),
                    "cold_s": round(cold, 2),
                    "frames": t,
                    "final_rank": pmd.rank,
                    "model_tflop": round(flops / 1e12, 3),
                    "achieved_tflops": round(tflops, 3),
                    "share_of_bf16_peak": round(tflops / peaks["bf16_tflops"], 5),
                    "peaks": peaks,
                    "stages": _stage_stats(stage_timings),
                    **(
                        {"leg_1024x1024x4096_u16": big_leg}
                        if big_leg is not None
                        else {}
                    ),
                    **(
                        {"highest_precision_mpf_s": round(hi_mpfs, 2)}
                        if hi_mpfs is not None
                        else {}
                    ),
                    "note": (
                        "matmul-FLOP model (~±20%); stage timings are host "
                        "clock marks on an async pipeline"
                    ),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
