"""North-star workload: 512x512 x 30,000-frame uint16 movie streamed FROM DISK.

BASELINE.json's throughput target (>= 1 Gpf/s, 125 Mpf/s/chip) is defined on
this workload — a two-photon-scale movie that must be streamed (statistics
pass + init + blockwise decomposition + full-movie V regression). Unlike
``bench.py`` (device-resident input isolating decomposition throughput), this
measures the whole system including disk IO and host->device transfer, with
the loader's double-buffered async device_put overlap.

The script also measures each leg in isolation (disk read bandwidth, H2D
bandwidth) so the end-to-end number can be attributed: streaming throughput
is capped at H2D bandwidth / streamed bytes per pixel-frame regardless of
compute speed.

Writes ONE JSON line. Usage:
    python bench_northstar.py [--frames 30000] [--keep-file]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

D1 = D2 = 512
DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "northstar_512x512.u16.raw")


def generate_movie_file(path: str, t: int, seed: int = 0, chunk: int = 2048):
    """Rank-16 + noise movie as uint16 on disk (photon-count-like offsets).
    Noise is drawn directly in float32 (the f64-then-cast path is ~10x
    slower at the 7.9e9 samples this file needs)."""
    rng = np.random.default_rng(seed)
    spatial = rng.standard_normal((D1 * D2, 16), dtype=np.float32)
    with open(path, "wb") as f:
        for s in range(0, t, chunk):
            n = min(chunk, t - s)
            temporal = rng.standard_normal((16, n), dtype=np.float32)
            block = (spatial @ temporal).T.reshape(n, D1, D2)
            block += rng.standard_normal((n, D1, D2), dtype=np.float32)
            np.clip(block * 40.0 + 1000.0, 0, 65535, out=block)
            f.write(block.astype("<u2").tobytes())


def measure_disk_bw(path: str, n_bytes: int = 1 << 30) -> float:
    """EFFECTIVE sequential read bandwidth of the movie file — page cache
    included, which is what the pipeline's own reads experience (the
    just-generated file is typically cached)."""
    t0 = time.perf_counter()
    read = 0
    with open(path, "rb", buffering=0) as f:
        while read < n_bytes:
            b = f.read(1 << 24)
            if not b:
                break
            read += len(b)
    return read / (time.perf_counter() - t0)


def measure_h2d_bw(n_bytes: int = 1 << 29) -> float:
    """Host->device bandwidth of one large transfer, after warm-up
    transfers (a streaming pass sees the sustained rate)."""
    import jax

    buf = np.empty(n_bytes, dtype=np.uint8)
    for _ in range(3):  # warm-up
        jax.block_until_ready(jax.device_put(buf))
    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(buf))
    return n_bytes / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30000)
    ap.add_argument("--path", default=DEFAULT_PATH)
    ap.add_argument("--keep-file", action="store_true")
    ap.add_argument("--skip-legs", action="store_true",
                    help="skip the per-leg bandwidth measurements")
    args = ap.parse_args()

    t = args.frames
    n_bytes = t * D1 * D2 * 2
    if not (os.path.exists(args.path) and os.path.getsize(args.path) == n_bytes):
        print(f"generating {n_bytes/1e9:.1f} GB movie at {args.path}...",
              file=sys.stderr, flush=True)
        generate_movie_file(args.path, t)

    from localmd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    legs = {}
    if not args.skip_legs:
        legs["disk_read_effective_MBps"] = round(measure_disk_bw(args.path) / 1e6, 1)
        legs["h2d_sustained_MBps"] = round(measure_h2d_bw() / 1e6, 1)

    import logging

    import localmd_tpu
    from localmd_tpu.dataset import RawBinaryArray

    logging.getLogger("localmd_tpu").setLevel(logging.INFO)

    dataset = RawBinaryArray(args.path, (t, D1, D2), dtype="<u2")
    t0 = time.perf_counter()
    pmd = localmd_tpu.localmd_decomposition(
        dataset,
        (32, 32),
        frame_range=4096,
        max_components=20,
        background_rank=15,
        temporal_avg_factor=10,
        sim_iters=250,
        seed=0,
        rank_prune=True,
        num_workers=4,
    ).block_until_ready()
    elapsed = time.perf_counter() - t0

    pixel_frames = t * D1 * D2
    mpfs = pixel_frames / elapsed / 1e6
    # the movie streams twice (stats pass + V regression) in uint16, MINUS
    # the HBM-cached prefix the V pass reads from device memory instead
    cache = getattr(pmd, "pipeline_cache", {"cached_frames": 0})
    cached_bytes = cache["cached_frames"] * D1 * D2 * 2
    stream_bytes = 2 * n_bytes - cached_bytes
    legs["cached_frames"] = cache["cached_frames"]
    legs["streamed_GB"] = round(stream_bytes / 1e9, 2)
    legs["achieved_stream_MBps"] = round(stream_bytes / elapsed / 1e6, 1)
    if "h2d_sustained_MBps" in legs:
        # bytes-per-pixel-frame actually streamed: what the H2D leg permits
        bpp = stream_bytes / pixel_frames
        legs["h2d_bound_mpfs"] = round(legs["h2d_sustained_MBps"] / bpp, 1)

    print(
        json.dumps(
            {
                "metric": "Mpixel-frames/sec/chip, 512x512x30k uint16 FROM DISK",
                "value": round(mpfs, 2),
                "unit": "Mpf/s",
                "vs_baseline": round(mpfs / 125.0, 4),
                "detail": {
                    "elapsed_s": round(elapsed, 1),
                    "frames": t,
                    "final_rank": pmd.rank,
                    "stage_timings_s": getattr(pmd, "pipeline_timings", None),
                    "aot": getattr(pmd, "pipeline_aot", None),
                    "stage_warms": getattr(pmd, "pipeline_warm", None),
                    **legs,
                },
            }
        )
    )
    if not args.keep_file and args.path == DEFAULT_PATH:
        os.unlink(args.path)


if __name__ == "__main__":
    main()
