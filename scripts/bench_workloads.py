"""Secondary workload benchmarks (voltage multi-window, widefield 1024^2,
volumetric stack).

Same measurement discipline as bench.py: device-resident synthetic movie,
cold + N warm runs, each ended by ``block_until_ready``, report best +
median wall. Select with argv[1] ('voltage' | 'widefield' | 'volumetric');
prints one JSON line per workload.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import logging

import jax
import jax.numpy as jnp


def make_movie(d1, d2, t, rank=16, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    spatial = jax.random.normal(k1, (d1 * d2, rank), dtype=jnp.float32)
    temporal = jax.random.normal(k2, (rank, t), dtype=jnp.float32)
    movie = (spatial @ temporal).T.reshape(t, d1, d2)
    movie = movie + jax.random.normal(k3, (t, d1, d2), dtype=jnp.float32)
    return jax.block_until_ready(movie)


def run(workload):
    import localmd_tpu
    from localmd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    logging.getLogger("localmd_tpu").setLevel(logging.WARNING)
    if workload == "voltage":
        d1 = d2 = 256
        t = 20000
        movie = make_movie(d1, d2, t)
        kwargs = dict(
            block_sizes=(32, 32), frame_range=4000, window_chunks=2000,
            max_components=20, background_rank=15, temporal_avg_factor=10,
            sim_iters=250, seed=0,
        )
    elif workload == "widefield":
        d1 = d2 = 1024
        t = 1024
        movie = make_movie(d1, d2, t)
        kwargs = dict(
            block_sizes=(40, 40), frame_range=1024, max_components=20,
            background_rank=15, temporal_avg_factor=10, sim_iters=250,
            seed=0, rank_prune=True,
        )
    elif workload == "volumetric":
        # BASELINE.json config 5: multi-plane stack, per-plane PMD. 8 planes
        # of 256x256x1024; planes share every compiled program, so the
        # steady-state per-plane cost is the pipeline's warm time.
        from localmd_tpu.volumetric import volumetric_decomposition

        d1 = d2 = 256
        t = 1024
        n_planes = 8
        # device-resident planes (same measurement discipline as the other
        # workloads: decomposition throughput, not host->device IO)
        planes = [make_movie(d1, d2, t, seed=z) for z in range(n_planes)]
        kwargs = dict(
            block_sizes=(32, 32), frame_range=1024, max_components=20,
            background_rank=15, temporal_avg_factor=10, sim_iters=250, seed=0,
        )
        times = []
        t0 = time.perf_counter()
        vol = volumetric_decomposition(planes, **kwargs)
        for p in vol.planes:
            p.block_until_ready()
        cold = time.perf_counter() - t0
        for p in vol.planes:
            p.close(materialize=False)
        for _ in range(3):
            t0 = time.perf_counter()
            vol = volumetric_decomposition(planes, **kwargs)
            for p in vol.planes:
                p.block_until_ready()
            times.append(time.perf_counter() - t0)
            for p in vol.planes:
                p.close(materialize=False)
        best = min(times)
        mpfs = n_planes * d1 * d2 * t / best / 1e6
        print(json.dumps({
            "workload": workload, "n_planes": n_planes,
            "mpf_s": round(mpfs, 1), "warm_best_s": round(best, 2),
            "warm_median_s": round(sorted(times)[len(times) // 2], 2),
            "cold_s": round(cold, 1),
        }))
        return
    else:
        raise SystemExit(f"unknown workload {workload}")

    times = []
    pmd = None
    t0 = time.perf_counter()
    pmd = localmd_tpu.localmd_decomposition(movie, **kwargs).block_until_ready()
    cold = time.perf_counter() - t0
    pmd.close(materialize=False)
    for _ in range(3):
        t0 = time.perf_counter()
        pmd = localmd_tpu.localmd_decomposition(movie, **kwargs).block_until_ready()
        times.append(time.perf_counter() - t0)
        pmd.close(materialize=False)
    best = min(times)
    mpfs = d1 * d2 * t / best / 1e6
    print(json.dumps({
        "workload": workload, "mpf_s": round(mpfs, 1),
        "warm_best_s": round(best, 2),
        "warm_median_s": round(sorted(times)[len(times) // 2], 2),
        "cold_s": round(cold, 1),
    }))


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "voltage")
