"""Time, on one GPU, the plain-XLA paths and each fast-path setting.

Three measurements, one JSON document (printed, and written to ``--out``):

1. ``kernels``: the XLA statistics step (``_to_fov_f32`` +
   ``get_mean_and_noise``) and the dense V-projection chunk
   (``loader._v_projection_kernel``, r' = 320) on one 1024-frame 512x512
   chunk in float32 and uint16, beside their bandwidth and FLOP bounds, a
   large copy and a large bf16 matmul measured in the same process.
2. ``paths``: warm end-to-end time of ``localmd_decomposition`` on the
   512x512x2048 benchmark movie (``bench.py`` arguments, ``aot_warm=False``)
   for each path flag of the ``gpu`` row of ``localmd_tpu.capabilities``:
   ``--pairs`` alternating pairs of one warm run with the row's setting and
   one with the flag flipped (the order inside a pair alternates too), after
   one priming run of each. Reports each setting's median and interquartile
   range and the median paired difference, and the time of
   ``reconstruct_frames`` over 512 frames with the row's setting.
3. ``aot``: cold (persistent compile cache off) and warm time with
   ``aot_warm`` False and True, each in a fresh child process that holds
   the card alone (the parent has not touched the card yet).

Usage (repository root)::

    python scripts/time_paths.py [--out chiprun_out/time_paths.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_KW = dict(
    frame_range=1024, max_components=20, background_rank=15,
    temporal_avg_factor=10, sim_iters=250, seed=0, block_batch_size=256,
    rank_prune=True,
)
HBM_BYTES_S = 3.35e12   # H100 SXM data sheet
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
CHUNK = (1024, 512, 512)     # one stats chunk: frames, d1, d2
RANK = 320                   # r' of the V projection
MOVIE = (2048, 512, 512)     # the benchmark movie


def _timed(fn, *args, reps=20):
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {"median_s": ts[len(ts) // 2], "min_s": ts[0]}


def kernels():
    import jax
    import jax.numpy as jnp

    from localmd_tpu.loader import _to_fov_f32, _v_projection_kernel
    from localmd_tpu.ops.noise import get_mean_and_noise

    (t, d1, d2), r = CHUNK, RANK
    d = d1 * d2
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    base = jax.random.normal(k1, (t, d1, d2), jnp.float32) * 40.0 + 1000.0
    a = jax.random.normal(k2, (d, r), jnp.float32) * 1e-3
    c = jax.random.normal(k3, (r,), jnp.float32)

    def stats(raw):
        return get_mean_and_noise(_to_fov_f32(raw), t)

    out = {}
    for name, raw in (("float32", base), ("uint16", base.astype(jnp.uint16))):
        raw_bytes = raw.size * raw.dtype.itemsize
        st = _timed(stats, raw)
        st_flops = 2 * 2 * 7 * 256 * 64 * d      # band DFT, HIGHEST (f32)
        st_bound = max((raw_bytes + 2 * d * 4) / HBM_BYTES_S,
                       st_flops / FP32_FLOPS)
        out[f"stats_{name}"] = {
            **st, "bytes": raw_bytes + 2 * d * 4, "flops": st_flops,
            "bound_s": st_bound, "roofline_share": st_bound / st["median_s"],
        }
        vp = _timed(lambda x: _v_projection_kernel(a, c, x, "F"), raw)
        vp_bytes = raw_bytes + d * r * 4 + r * t * 4
        vp_flops = 2 * d * t * r
        out[f"vproj_{name}"] = {
            **vp, "bytes": vp_bytes, "flops": vp_flops,
            "hbm_bound_s": vp_bytes / HBM_BYTES_S,
            "tf32_bound_s": vp_flops / TF32_FLOPS,
            "fp32_bound_s": vp_flops / FP32_FLOPS,
            "roofline_share_tf32": max(vp_bytes / HBM_BYTES_S,
                                       vp_flops / TF32_FLOPS) / vp["median_s"],
        }
    big = jnp.zeros((t * d, ), jnp.float32)       # one f32 chunk
    cp = _timed(lambda x: x * 2.0, big)
    out["copy_chunk_f32"] = {**cp, "bytes_s": 2 * big.nbytes / cp["median_s"]}
    m = jax.random.normal(k1, (8192, 8192), jnp.bfloat16)
    mm = _timed(lambda x: x @ x, m, reps=10)
    out["bf16_matmul_8192"] = {**mm, "flops_s": 2 * 8192 ** 3 / mm["median_s"]}
    return out


def _run(movie, **kw):
    import localmd_tpu

    t0 = time.perf_counter()
    pmd = localmd_tpu.localmd_decomposition(movie, (32, 32), **BENCH_KW, **kw)
    pmd.block_until_ready()
    return pmd, time.perf_counter() - t0


def _quartiles(xs):
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median_s": float(med), "q1_s": float(q1), "q3_s": float(q3)}


def _pipeline_times(movie, n_warm=5, **kw):
    pmd, first = _run(movie, **kw)
    warms = []
    for _ in range(n_warm):
        pmd, w = _run(movie, **kw)
        warms.append(w)
    warms.sort()
    return {
        "first_s": first, "warm_median_s": warms[len(warms) // 2],
        "warm_min_s": warms[0], "warm_s": warms, "rank": pmd.rank,
        "stage_marks_s": pmd.pipeline_timings,
    }, pmd


FLAGS = {
    "banded_gram": ("localmd_tpu.blocksparse", "BANDED_GRAM"),
    "coset_vproj": ("localmd_tpu.blocksparse", "COSET_VPROJ"),
}


def _set_flag(name, val):
    import importlib

    mod, attr = FLAGS[name]
    setattr(importlib.import_module(mod), attr, val)


def paths(pairs: int):
    import numpy as np

    from localmd_tpu.capabilities import FAST_PATHS
    from localmd_tpu.sim import two_photon_movie

    t, d1, d2 = MOVIE
    movie = two_photon_movie(d1, d2, t, seed=0)
    frames = np.arange(0, t, t // 64)
    out = []
    for name in FLAGS:
        row_val = FAST_PATHS["gpu"][name]
        times = {row_val: [], not row_val: []}
        recs, marks = {}, {}
        for val in (row_val, not row_val):       # priming: compile both
            _set_flag(name, val)
            pmd, _ = _run(movie, aot_warm=False)
            recs[val] = np.asarray(pmd.reconstruct_frames(frames), np.float64)
            if val == row_val and not out:
                recon = _timed(lambda: pmd.reconstruct_frames(np.arange(512)))
        for i in range(pairs):
            order = (row_val, not row_val) if i % 2 == 0 else (not row_val, row_val)
            for val in order:
                _set_flag(name, val)
                pmd, w = _run(movie, aot_warm=False)
                times[val].append(w)
                marks.setdefault(val, []).append(pmd.pipeline_timings)
        _set_flag(name, "auto")
        diffs = np.asarray(times[not row_val]) - np.asarray(times[row_val])
        ref = recs[row_val] - 100.0
        rec = {
            "flag": name, "row_value": row_val, "pairs": pairs,
            "row": _quartiles(times[row_val]),
            "flipped": _quartiles(times[not row_val]),
            "median_diff_flipped_minus_row_s": float(np.median(diffs)),
            "pairs_row_faster": int(np.sum(diffs > 0)),
            "row_s": times[row_val], "flipped_s": times[not row_val],
            "row_stage_marks_s": marks[row_val][-1],
            "flipped_stage_marks_s": marks[not row_val][-1],
            "rel_diff_flipped_vs_row": float(
                np.linalg.norm(recs[not row_val] - 100.0 - ref)
                / np.linalg.norm(ref)
            ),
        }
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return {"flags": out, "reconstruct_512_frames_row": recon}


def aot_child(aot: bool):
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    from localmd_tpu.sim import two_photon_movie

    t, d1, d2 = MOVIE
    movie = jax.block_until_ready(two_photon_movie(d1, d2, t, seed=0))
    res, pmd = _pipeline_times(movie, n_warm=3, aot_warm=aot)
    res["warm_errors"] = pmd.pipeline_warm["errors"]
    res["warms_completed"] = len(pmd.pipeline_warm["completed"])
    print(json.dumps({"aot_warm": aot, **res}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--aot-child", choices=["true", "false"], default=None)
    ap.add_argument("--skip", default="", help="comma list: kernels,paths,aot")
    ap.add_argument("--aot-runs", default="false,true,false,true",
                    help="aot_warm setting of each cold child, in order")
    ap.add_argument("--pairs", type=int, default=20,
                    help="alternating on/off pairs per path flag")
    args = ap.parse_args()
    if args.aot_child is not None:
        aot_child(args.aot_child == "true")
        return
    skip = set(filter(None, args.skip.split(",")))
    doc = {}
    if "aot" not in skip:
        # children first: the parent must not hold the card while they run
        doc["aot"] = []
        for val in args.aot_runs.split(","):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--aot-child", val],
                capture_output=True, text=True, check=True,
            )
            doc["aot"].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(doc["aot"][-1]), flush=True)
    import jax

    from localmd_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"time_paths.py needs a GPU, found {dev.platform!r}")
    enable_compile_cache()
    doc["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    doc["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if "kernels" not in skip:
        doc["kernels"] = kernels()
        print(json.dumps(doc["kernels"]), flush=True)
    if "paths" not in skip:
        doc["paths"] = paths(args.pairs)
    text = json.dumps(doc, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"device": doc["device"], "nvidia_smi": doc["nvidia_smi"]}))


if __name__ == "__main__":
    main()
