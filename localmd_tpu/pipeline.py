"""End-to-end PMD pipeline: ``localmd_decomposition``.

Orchestrates the full flow (parity with the reference entry point,
reference decomposition.py:643-909):

  stream stats -> background SVD -> frame sampling -> threshold Monte-Carlo
  -> standardize + background-filter init frames (device-resident)
  -> batched windowed blockwise decomposition over the WHOLE patch grid
  -> pyramid-weighted overlap-add normalization (blocked-sparse U)
  -> factorized SVD (only_left) -> streaming V regression (full movie)
  -> final SVD reformat -> PMDArray.

The block loop is replaced by chunked batched kernels: blocks are processed
in fixed-size batches (padded on the last chunk) so a handful of compiled
programs cover any FOV. Chunk size bounds patch HBM:
chunk * b1 * b2 * T_init * 4 bytes.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.capabilities import resolve
from localmd_tpu.dataset import as_dataset
from localmd_tpu import engine
from localmd_tpu.engine import (
    identity,
    threshold_heuristic,
    windowed_pmd_batched,
)
from localmd_tpu.factorization import compute_lowrank_factorized_svd, final_svd_reformat
from localmd_tpu.loader import PMDLoader
from localmd_tpu.ops.tiling import (
    block_grid,
    check_fov_size,
    extract_patches,
    update_block_sizes,
)
from localmd_tpu.pmd_array import PMDArray
from localmd_tpu.utils import display, is_device_oom, make_key_with_seed


def identify_window_chunks(
    frame_range: int, total_frames: int, window_chunks: int, np_rng=None
) -> list:
    """Sample non-overlapping contiguous chunks of frames for initialization
    (reference decomposition.py:528-569).

    ``np_rng``: numpy RandomState/Generator to draw from (defaults to the
    global ``np.random`` module, matching the reference); the pipeline passes
    a local RandomState so seeded runs stay deterministic even when several
    planes run concurrently in threads (volumetric ``devices=``)."""
    if frame_range > total_frames:
        raise ValueError("Requested more frames than available")
    if window_chunks > frame_range:
        raise ValueError("The size of each temporal chunk is bigger than frame range")

    num_intervals = math.ceil(frame_range / window_chunks)
    available = np.arange(0, total_frames, window_chunks)
    if available[-1] > total_frames - window_chunks:
        available[-1] = total_frames - window_chunks
    if np_rng is None:
        np_rng = np.random
    starts = np.sort(np_rng.choice(available, size=num_intervals, replace=False))
    display(f"sampled from the following regions: {starts}")

    net_frames: list = []
    for k in starts:
        net_frames.extend(range(int(k), int(min(k + window_chunks, total_frames))))
    return net_frames


def _value_token(v, depth: int = 0) -> bytes:
    """Content bytes of a value captured in a denoiser closure, for the
    checkpoint resume fingerprint. repr() is NOT safe here: it truncates
    large arrays (collisions -> silently stale resumes) and embeds
    per-process addresses for functions/objects (spurious invalidation
    every run)."""
    if depth > 3:
        return b"<deep>"
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return repr(v).encode()
    if isinstance(v, np.generic):  # numpy scalar: repr(type) alone would
        return b"ns" + str(v.dtype).encode() + v.tobytes()  # miss the VALUE
    if isinstance(v, np.ndarray):
        return b"nd" + str(v.shape).encode() + str(v.dtype).encode() + v.tobytes()
    if isinstance(v, jax.Array):
        try:
            return _value_token(np.asarray(v), depth)
        except Exception:
            return b"<jax-array>"
    if isinstance(v, (tuple, list)):
        return b"[" + b",".join(_value_token(x, depth + 1) for x in v) + b"]"
    if isinstance(v, dict):
        return b"{" + b",".join(
            _value_token(k, depth + 1) + b":" + _value_token(x, depth + 1)
            for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))
        ) + b"}"
    code = getattr(v, "__code__", None)
    if code is not None:  # captured function: hash its content, not id
        token = code.co_code + repr(code.co_consts).encode()
        defaults = getattr(v, "__defaults__", None)
        if defaults:  # changed default-arg values must also invalidate
            token += _value_token(tuple(defaults), depth + 1)
        return token
    # unknown object: type identity only (stable across processes)
    return repr(type(v)).encode()


def _fn_token(fn) -> str | None:
    """Checkpoint-fingerprint token of a user-supplied denoiser: qualname +
    a hash of bytecode, constants, and closure contents, so editing the
    function body or a captured value invalidates resumable stages."""
    if fn is None:
        return None
    name = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"
    code = getattr(fn, "__code__", None)
    if code is not None:
        payload = code.co_code + repr(code.co_consts).encode()
        defaults = getattr(fn, "__defaults__", None)
        if defaults:
            payload += _value_token(tuple(defaults))
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                payload += _value_token(cell.cell_contents)
            except ValueError:  # empty cell
                payload += b"<empty>"
        name += ":" + hashlib.sha256(payload).hexdigest()[:12]
    return name


def localmd_decomposition(
    dataset_obj,
    block_sizes: Tuple[int, int],
    frame_range: int,
    max_components: int = 50,
    background_rank: int = 15,
    sim_conf: float = 5,
    frame_batch_size: int = 10000,
    dtype: str = "float32",
    num_workers: int = 0,
    pixel_batch_size: int = 5000,
    max_consecutive_failures: int = 1,
    rank_prune: bool = False,
    rank_prune_factor: float = 0.33,
    temporal_avg_factor: int = 10,
    spatial_avg_factor: int = 2,
    order: str = "F",
    window_chunks: Optional[int] = None,
    compute_normalizer: bool = True,
    pixel_weighting: Optional[np.ndarray] = None,
    spatial_denoiser: Optional[Callable] = None,
    temporal_denoiser: Optional[Callable] = None,
    seed: Optional[int] = None,
    block_batch_size: int = 256,
    sim_iters: int = 250,
    final_rank_tol: float = 1e-3,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    matmul_precision: Optional[str] = None,
    profile_dir: Optional[str] = None,
    welch_compat: str = "scipy",
    cache_movie="auto",
    aot_warm="auto",
) -> PMDArray:
    """Run the full PMD compression/denoising pipeline (reference signature,
    decomposition.py:643-664, plus ``seed``/``block_batch_size``/``sim_iters``/
    ``final_rank_tol``/``mesh``).

    With ``mesh`` (a 1-D jax.sharding.Mesh), the block decomposition is
    shard_map'd over the mesh's block axis and the streaming V regression is
    sharded over frames (see localmd_tpu.parallel).

    With ``checkpoint_path``, each completed stage persists its outputs and a
    rerun with identical config resumes after the last completed stage (the
    reference pipeline cannot resume, SURVEY.md §5).

    ``matmul_precision`` (e.g. "bfloat16", "tensorfloat32", "highest") sets
    jax's default matmul precision for the whole pipeline. With None, f32
    products use the backend's default precision, which on a GPU may be
    TF32; pass "highest" for full-f32 matmuls at a throughput cost. The
    reference-parity tests pass under both.

    ``cache_movie``: "auto" (default) retains already-streamed frames in
    device HBM during the stats pass (as many leading frames as fit half of
    free memory, native dtype) so the init-frame load and the V-regression
    pass read HBM instead of re-streaming the movie through the host link;
    True forces caching, False disables it.

    ``welch_compat``: "scipy" (default) estimates per-pixel noise with the
    documented 256-sample-segment Welch semantics; "reference" reproduces
    the reference package's *effective* std_img (one full-chunk-length
    periodogram, hardcoded [65, 129) band — see
    ops.noise.welch_noise_estimate_ref_compat) for strict numerical parity.

    ``aot_warm``: "auto" (default) AOT-compiles the block-stage program on
    a background thread while the statistics pass streams the movie, hiding
    the one-time program compile+load behind IO (localmd_tpu.aot); "auto"
    reads the backend's row of localmd_tpu.capabilities.FAST_PATHS. True
    forces it on, False disables. Results are identical either way.
    """
    if profile_dir is not None:
        # capture a jax profiler trace of the whole pipeline (viewable in
        # TensorBoard / Perfetto). The reference has no profiling hooks.
        with jax.profiler.trace(profile_dir):
            return localmd_decomposition(
                dataset_obj, block_sizes, frame_range,
                max_components=max_components, background_rank=background_rank,
                sim_conf=sim_conf, frame_batch_size=frame_batch_size,
                dtype=dtype, num_workers=num_workers,
                pixel_batch_size=pixel_batch_size,
                max_consecutive_failures=max_consecutive_failures,
                rank_prune=rank_prune, rank_prune_factor=rank_prune_factor,
                temporal_avg_factor=temporal_avg_factor,
                spatial_avg_factor=spatial_avg_factor, order=order,
                window_chunks=window_chunks, compute_normalizer=compute_normalizer,
                pixel_weighting=pixel_weighting, spatial_denoiser=spatial_denoiser,
                temporal_denoiser=temporal_denoiser, seed=seed,
                block_batch_size=block_batch_size, sim_iters=sim_iters,
                final_rank_tol=final_rank_tol, mesh=mesh,
                checkpoint_path=checkpoint_path,
                matmul_precision=matmul_precision, profile_dir=None,
                welch_compat=welch_compat, cache_movie=cache_movie,
                aot_warm=aot_warm,
            )
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return localmd_decomposition(
                dataset_obj, block_sizes, frame_range,
                max_components=max_components, background_rank=background_rank,
                sim_conf=sim_conf, frame_batch_size=frame_batch_size,
                dtype=dtype, num_workers=num_workers,
                pixel_batch_size=pixel_batch_size,
                max_consecutive_failures=max_consecutive_failures,
                rank_prune=rank_prune, rank_prune_factor=rank_prune_factor,
                temporal_avg_factor=temporal_avg_factor,
                spatial_avg_factor=spatial_avg_factor, order=order,
                window_chunks=window_chunks, compute_normalizer=compute_normalizer,
                pixel_weighting=pixel_weighting, spatial_denoiser=spatial_denoiser,
                temporal_denoiser=temporal_denoiser, seed=seed,
                block_batch_size=block_batch_size, sim_iters=sim_iters,
                final_rank_tol=final_rank_tol, mesh=mesh,
                checkpoint_path=checkpoint_path, matmul_precision=None,
                welch_compat=welch_compat, cache_movie=cache_movie,
                aot_warm=aot_warm,
            )
    from localmd_tpu.checkpoint import PipelineCheckpoint
    import time as _time

    timings: dict = {}
    _t0 = _time.perf_counter()
    # Debug: LOCALMD_FENCE_STAGES=1 drains the device queue before each
    # stage mark, so ``pipeline_timings`` attributes DEVICE time to the
    # stage that queued it rather than to the next blocking D2H pull
    # (async dispatch otherwise books ~all device work to the two sync
    # points). Each fence costs one D2H round trip — measurement only.
    import os as _os

    _fence_stages = _os.environ.get("LOCALMD_FENCE_STAGES") == "1"

    def _mark(stage):
        nonlocal _t0
        if _fence_stages:
            try:
                float(jnp.zeros((), jnp.float32) + jnp.float32(0))
            except Exception:
                pass
        now = _time.perf_counter()
        timings[stage] = round(now - _t0, 4)
        _t0 = now

    dataset_obj = as_dataset(dataset_obj)
    check_fov_size((dataset_obj.shape[1], dataset_obj.shape[2]))
    if order not in ("F", "C"):
        raise ValueError(f"order must be 'F' or 'C', got {order!r}")
    # Fail FAST on a misconfigured jax.distributed run — BEFORE any
    # streaming (a mesh-less 2-process run previously crashed only after
    # the stats pass, block stage, fsvd AND the V stream).
    from localmd_tpu.parallel.multihost import (
        is_multihost,
        validate_multihost_mesh,
    )

    validate_multihost_mesh(mesh)
    multi_host = is_multihost()
    if multi_host and checkpoint_path is not None:
        raise ValueError(
            "checkpoint_path is not supported under jax.distributed yet: "
            "every process would race writing identical stage files to the "
            "same path. Run with checkpoint_path=None, or checkpoint from "
            "a single-host run."
        )
    # Seeded runs draw window samples / background frames from a LOCAL
    # RandomState (bit-identical stream to the previous global
    # ``np.random.seed(seed)``: same MT19937, same consumption order) so
    # concurrent plane-parallel pipelines in threads (volumetric
    # ``devices=``) stay deterministic; unseeded runs keep the reference's
    # global-``np.random`` behavior.
    np_rng = np.random.RandomState(seed) if seed is not None else np.random
    key, effective_seed = make_key_with_seed(seed)

    # Content-sensitive arguments must be part of the resume fingerprint:
    # resuming a checkpoint written with a different pixel weighting or
    # denoiser would silently return results computed with the old settings.
    if pixel_weighting is not None:
        pw = np.ascontiguousarray(np.asarray(pixel_weighting, dtype=np.float32))
        pixel_weighting_token = hashlib.sha256(pw.tobytes()).hexdigest()[:16]
    else:
        pixel_weighting_token = None

    ckpt = PipelineCheckpoint(
        checkpoint_path,
        dict(
            shape=tuple(int(x) for x in dataset_obj.shape),
            block_sizes=tuple(block_sizes), frame_range=frame_range,
            max_components=max_components, background_rank=background_rank,
            sim_conf=sim_conf, max_consecutive_failures=max_consecutive_failures,
            rank_prune=rank_prune, rank_prune_factor=rank_prune_factor,
            temporal_avg_factor=temporal_avg_factor,
            spatial_avg_factor=spatial_avg_factor, order=order,
            window_chunks=window_chunks, seed=seed, sim_iters=sim_iters,
            welch_compat=welch_compat,
            pixel_weighting=pixel_weighting_token,
            spatial_denoiser=_fn_token(spatial_denoiser),
            temporal_denoiser=_fn_token(temporal_denoiser),
        ),
    )

    precomputed = {}
    if ckpt.has("stats"):
        display("Resuming: statistics stage loaded from checkpoint")
        precomputed.update(ckpt.load("stats"))
    if ckpt.has("background"):
        display("Resuming: background stage loaded from checkpoint")
        precomputed.update(ckpt.load("background"))

    # Resolve denoisers before the loader: the AOT warm-compile plan below
    # needs the exact static callables the block stage will trace with.
    sden = spatial_denoiser if spatial_denoiser is not None else identity
    tden = temporal_denoiser if temporal_denoiser is not None else identity

    # -- background AOT warm-compile (localmd_tpu.aot) -------------------------
    # While the stats pass streams the movie, a daemon thread compiles +
    # loads the block-stage program for the predicted geometry. "auto" reads
    # the capability table; results are identical either way (dispatch
    # falls back on any geometry mismatch).
    warmer = None
    stage_warmer = None
    stats_hook = None
    aot_enabled = resolve(aot_warm, "aot_warm")
    if aot_enabled:
        from localmd_tpu.aot import (
            BlockProgramWarmer,
            StageWarmer,
            plan_block_stage,
        )
        from localmd_tpu.utils import ambient_device, ambient_device_or_first

        stage_warmer = StageWarmer(device=ambient_device())
        if mesh is None and not ckpt.has("blocks"):
            warmer = BlockProgramWarmer()
        _orig_window_chunks = window_chunks  # pre-normalization values
        _orig_frame_range = frame_range

        def stats_hook(loader, cache_target):
            # Thresholds are a data-INDEPENDENT Monte-Carlo on pure noise
            # (engine.threshold_heuristic), memoized on host-side tokens:
            # compute them for real while the stats pass streams — the
            # main-thread call below then hits the memo. The subkey is the
            # first split of the pipeline key, reproduced here without
            # consuming the pipeline's copy (jax.random.split is pure).
            if not ckpt.has("thresholds"):
                from localmd_tpu.aot import normalized_init_geometry

                try:
                    _, wc_w, b1_w, b2_w = normalized_init_geometry(
                        loader.shape, _orig_frame_range,
                        _orig_window_chunks, block_sizes,
                    )
                except ValueError:
                    b1_w = None
                if b1_w is not None:
                    # bind the key VALUE now: the main thread rebinds the
                    # ``key`` variable at its own thresholds split, and the
                    # warm thread may run after that
                    def _warm_thresholds(key_now=key):
                        _, sub_w = jax.random.split(key_now)
                        threshold_heuristic(
                            (b1_w, b2_w, wc_w),
                            num_comps=1,
                            iters=sim_iters,
                            percentile_threshold=sim_conf,
                            key=sub_w,
                            as_device=checkpoint_path is None,
                            cache_token=("pipeline-thr", effective_seed),
                        )

                    stage_warmer.start(
                        "thresholds", _warm_thresholds,
                        token=(b1_w, b2_w, wc_w, sim_iters, sim_conf,
                               effective_seed, checkpoint_path is None),
                    )
            if warmer is None:
                return
            resident_bytes = 0
            if loader._device_resident:
                arr = loader.dataset._array
                resident_bytes = arr.size * arr.dtype.itemsize
            plan = plan_block_stage(
                shape=loader.shape,
                frame_range=_orig_frame_range,
                window_chunks=_orig_window_chunks,
                block_sizes=block_sizes,
                max_components=max_components,
                temporal_avg_factor=temporal_avg_factor,
                spatial_avg_factor=spatial_avg_factor,
                block_batch_size=block_batch_size,
                cache_target_frames=cache_target,
                cache_itemsize=np.dtype(
                    getattr(loader.dataset, "raw_dtype", loader.dataset.dtype)
                ).itemsize,
                device_resident_bytes=resident_bytes,
                device=ambient_device_or_first(),
            )
            if plan is not None:
                warmer.start(
                    d1=plan["d1"], d2=plan["d2"],
                    # multi-window programs take the pre-gathered patch
                    # batch, whose time dim is the binning-cropped length
                    t_data=(
                        plan["crop_avg_constant"]
                        if plan["kind"] == "multi"
                        else plan["t_data"]
                    ),
                    bb=plan["bb"], b1=plan["b1"], b2=plan["b2"],
                    max_components=plan["max_components"],
                    temporal_avg_factor=temporal_avg_factor,
                    spatial_avg_factor=spatial_avg_factor,
                    max_consecutive_failures=max_consecutive_failures,
                    spatial_denoiser=sden, temporal_denoiser=tden,
                    t_used=plan["crop_avg_constant"],
                    device=ambient_device(),
                    kind=plan["kind"], n_windows=plan["n_windows"],
                    window_length=plan["window_length"],
                )

    load_obj = PMDLoader(
        dataset_obj,
        dtype=dtype,
        stats_started_hook=stats_hook,
        background_rank=background_rank,
        batch_size=frame_batch_size,
        pixel_batch_size=pixel_batch_size,
        order=order,
        compute_normalizer=compute_normalizer,
        seed=seed,
        num_workers=num_workers,
        precomputed=precomputed or None,
        welch_compat=welch_compat,
        cache_movie=cache_movie,
        np_rng=np_rng,
    )
    if not ckpt.has("stats"):
        ckpt.save("stats", mean_img=load_obj.mean_img, std_img=load_obj.std_img)
    if not ckpt.has("background"):
        ckpt.save("background", spatial_basis=load_obj.spatial_basis)
    _mark("stats_and_background")

    t_total, d1, d2 = load_obj.shape
    if window_chunks is None:
        window_chunks = frame_range

    # -- frame sampling (reference decomposition.py:678-693) ------------------
    if t_total < frame_range:
        display("WARNING: requested more frames than the dataset has")
        frame_range = t_total
        frames = list(range(t_total))
        window_chunks = min(window_chunks, frame_range)
    else:
        window_chunks = min(window_chunks, frame_range)
        frames = identify_window_chunks(frame_range, t_total, window_chunks, np_rng)
    display(f"Initializing on a total of {len(frames)} frames")

    block_sizes = update_block_sizes(tuple(block_sizes), (d1, d2))
    b1, b2 = block_sizes

    # -- thresholds (reference decomposition.py:700-711) ----------------------
    key, sub = jax.random.split(key)
    if ckpt.has("thresholds"):
        display("Resuming: thresholds loaded from checkpoint")
        thr = ckpt.load("thresholds")
        spatial_threshold = float(thr["spatial_threshold"])
        temporal_threshold = float(thr["temporal_threshold"])
    else:
        display(f"Running threshold simulations for blocks {b1} x {b2} x {window_chunks}")
        if stage_warmer is not None:
            # reuse the Monte-Carlo the warm thread ran during the stats
            # pass (identical memo key) instead of racing a duplicate
            stage_warmer.join("thresholds")
        # device scalars: no host sync between the simulation and the block
        # stage (the block kernels take thresholds as traced args). With
        # checkpointing enabled the save below would force the sync anyway,
        # so return host floats in that case.
        # Multi-host: every process runs this Monte-Carlo independently —
        # it is a pure function of (seed, shape, iters), so per-host
        # duplication is bit-identical and cheaper than a broadcast.
        spatial_threshold, temporal_threshold = threshold_heuristic(
            (b1, b2, window_chunks),
            num_comps=1,
            iters=sim_iters,
            percentile_threshold=sim_conf,
            key=sub,
            as_device=checkpoint_path is None,
            # host-side identity of ``sub``: the first split of
            # PRNGKey(effective_seed) — avoids pulling the key value
            cache_token=("pipeline-thr", effective_seed),
        )
        ckpt.save(
            "thresholds",
            spatial_threshold=spatial_threshold,
            temporal_threshold=temporal_threshold,
        )
    _mark("thresholds")

    # -- load + filter init frames (device-resident) --------------------------
    blocks_ckpt = ckpt.has("blocks")
    if blocks_ckpt:
        display("Resuming: blockwise decomposition loaded from checkpoint")
        data = None
    else:
        display("Loading and filtering initialization frames")
        try:
            data, temporal_basis_crop = load_obj.temporal_crop_with_filter(frames)
        except Exception as e:  # pragma: no cover - hardware OOM path
            # If the HBM movie cache left too little memory for the init
            # buffer, drop it and retry: a smaller cache win is better than
            # a dead run (the fallback budget is an estimate on runtimes
            # that report no memory_stats).
            if not is_device_oom(e) or load_obj._cache is None:
                raise
            display("WARNING: init-frame load hit device OOM; retrying without the movie cache")
            load_obj.release_cache()
            data, temporal_basis_crop = load_obj.temporal_crop_with_filter(frames)
        if pixel_weighting is not None:
            data = data * jnp.asarray(pixel_weighting, dtype=data.dtype)[:, :, None]

    t_init = len(frames)
    if temporal_avg_factor >= t_init:
        raise ValueError(f"Need at least {temporal_avg_factor} frames")
    if t_init // temporal_avg_factor <= max_components:
        max_components = int(t_init // temporal_avg_factor)
        display(
            f"WARNING: temporal avg factor too big; max rank per block adjusted "
            f"to {max_components}"
        )
    # rSVD sketch needs rank + oversamples <= binned frames & downsampled pixels
    sketch_limit = min(
        t_init // temporal_avg_factor,
        (b1 // spatial_avg_factor + (b1 % spatial_avg_factor > 0))
        * (b2 // spatial_avg_factor + (b2 % spatial_avg_factor > 0)),
    ) - 10
    if max_components > sketch_limit:
        max_components = int(sketch_limit)
        display(f"WARNING: max rank clamped to {max_components} for the rSVD sketch")
    if max_components <= 0:
        raise ValueError(
            "Configuration leaves no room for the rSVD sketch "
            f"(max_components clamped to {max_components}): increase "
            "frame_range/window_chunks, or decrease temporal_avg_factor/"
            "spatial_avg_factor, or use larger blocks"
        )

    crop_avg_constant = (t_init // temporal_avg_factor) * temporal_avg_factor
    window_len_probe = min(window_chunks, crop_avg_constant)
    if not blocks_ckpt:
        temporal_basis_crop = temporal_basis_crop[:, :crop_avg_constant]
        if window_len_probe >= crop_avg_constant:
            # fused single-window path slices time inside the program — no
            # cropped copy of the init movie is ever materialized
            data_crop = data
        else:
            data_crop = (
                data[:, :, :crop_avg_constant]
                if crop_avg_constant != t_init
                else data
            )
        data = None  # drop the extra reference

    # -- batched blockwise decomposition --------------------------------------
    grid = block_grid(d1, d2, (b1, b2), order=order)
    n_blocks = grid.n_blocks


    window_len = min(window_chunks, crop_avg_constant)
    single_window = window_len >= crop_avg_constant

    starts_host = grid.starts
    panels_chunks, counts_chunks, temporal_chunks = [], [], []
    # One PRNG key per (window,) block over the GLOBAL grid, split before the
    # batch loop: the batch size below is derived from free device memory, so
    # per-batch splitting would make a fixed seed yield different sketches
    # whenever free memory differs (e.g. after a prior in-process run).
    key, sub = jax.random.split(key)
    if single_window:
        block_keys = jax.random.split(sub, n_blocks)          # (N, 2)
    else:
        wl_eff = engine.effective_window_length(
            window_len, crop_avg_constant, temporal_avg_factor
        )
        n_windows_global = len(range(0, crop_avg_constant, wl_eff))
        block_keys = engine.window_keys(sub, n_windows_global, n_blocks)
    # Batch-size budget: shared with the AOT planner (plan_block_stage) via
    # utils.device.block_batch_budget — ONE formula, so the warm plan and
    # the dispatch can never silently disagree on the compiled batch shape.
    per_block_bytes = b1 * b2 * crop_avg_constant * 4 * 4
    from localmd_tpu.utils import ambient_device_or_first
    from localmd_tpu.utils.device import block_batch_budget

    dev = ambient_device_or_first()  # the chip this pipeline is pinned to
    bb = block_batch_budget(
        dev,
        per_block_bytes=per_block_bytes,
        n_blocks=n_blocks,
        block_batch_size=block_batch_size,
    )
    if mesh is not None:
        n_dev = mesh.devices.size
        bb = ((bb + n_dev - 1) // n_dev) * n_dev  # shardable chunk size
    if multi_host:
        # every process must dispatch the SAME global batch shape: take the
        # cross-process minimum (per-host memory_stats can differ; a
        # divergent bb would deadlock the SPMD dispatch)
        from localmd_tpu.parallel.multihost import agree_int_min

        bb = agree_int_min(bb)
    display(
        f"Decomposing {n_blocks} overlapping blocks "
        f"({b1}x{b2}, max {max_components} comps/block) in batches of {bb}"
    )
    if blocks_ckpt:
        loaded = ckpt.load("blocks")
        panels = jnp.asarray(loaded["panels"])
        counts = loaded["counts"]
        v_blocks = jnp.asarray(loaded["v_blocks"])
        temporal_basis_crop = jnp.asarray(loaded["temporal_basis_crop"])
        bb = 0  # skip the stage below

    # Multi-host block stage: the init movie is replicated ONCE as a global
    # array (every host computed an identical copy from shared storage);
    # starts/keys shard over the host-spanning mesh per batch; thresholds
    # are pulled to host scalars (device scalars are host-local arrays a
    # multi-host SPMD dispatch cannot consume).
    _mh_data_g = None
    _mh_thr = None
    if multi_host and not blocks_ckpt:
        from jax.sharding import PartitionSpec as _P

        from localmd_tpu.parallel import multihost as _mh

        if single_window:
            _mh_data_g = _mh.host_local_to_global(mesh, _P(), data_crop)
        _mh_thr = (
            np.float32(spatial_threshold),
            np.float32(temporal_threshold),
        )

    def _dispatch_batch(idx_padded):
        """Run one padded batch of block ids (need not be contiguous) through
        the compiled chunk program; returns the WindowedPMDResult."""
        starts_batch = jnp.asarray(starts_host[idx_padded])
        keys_batch = jnp.asarray(
            block_keys[idx_padded] if single_window else block_keys[:, idx_padded]
        )
        if multi_host:
            # SPMD over the host-spanning mesh; outputs are gathered so
            # every host continues with identical full panels (the cheap
            # downstream stages then run replicated per host — see
            # parallel.multihost module docs)
            from jax.sharding import PartitionSpec as _P

            from localmd_tpu.parallel import multihost as _mh
            from localmd_tpu.parallel.mesh import BLOCK_AXIS as _BA
            from localmd_tpu.parallel.sharded import (
                sharded_window0_chunk_step,
                sharded_windowed_pmd,
            )

            sthr_h, tthr_h = _mh_thr
            if single_window:
                starts_g = _mh.host_local_to_global(
                    mesh, _P(_BA), np.asarray(starts_batch)
                )
                keys_g = _mh.host_local_to_global(
                    mesh, _P(_BA), np.asarray(keys_batch)
                )
                acc_c, counts_c, v_c = sharded_window0_chunk_step(
                    mesh, _mh_data_g, starts_g, keys_g, b1, b2,
                    max_components, temporal_avg_factor, spatial_avg_factor,
                    sthr_h, tthr_h, max_consecutive_failures, sden, tden,
                    t_used=crop_avg_constant,
                )
            else:
                patch_batch = extract_patches(data_crop, starts_batch, b1, b2)
                patch_g = _mh.host_local_to_global(mesh, _P(_BA), patch_batch)
                keys_g = _mh.host_local_to_global(
                    mesh, _P(None, _BA), np.asarray(keys_batch), shard_axis=1
                )
                acc_c, counts_c, v_c = sharded_windowed_pmd(
                    mesh, patch_g, keys_g, sthr_h, tthr_h,
                    n_windows=n_windows_global, window_length=wl_eff,
                    max_rank=max_components,
                    temporal_avg_factor=temporal_avg_factor,
                    spatial_avg_factor=spatial_avg_factor,
                    max_consecutive_failures=max_consecutive_failures,
                    spatial_denoiser=sden, temporal_denoiser=tden,
                )
            return engine.WindowedPMDResult(
                *_mh.replicate_block_outputs(mesh, acc_c, counts_c, v_c)
            )
        if single_window and mesh is None and warmer is not None:
            compiled = warmer.get(
                data_crop.shape,
                int(starts_batch.shape[0]),
                (b1, b2, max_components, temporal_avg_factor,
                 spatial_avg_factor, max_consecutive_failures, sden, tden,
                 crop_avg_constant, "single", 0, 0),
            )
            if compiled is not None:
                try:
                    acc_c, counts_c, v_c = warmer(
                        data_crop, starts_batch, keys_batch,
                        spatial_threshold, temporal_threshold,
                    )
                    return engine.WindowedPMDResult(acc_c, counts_c, v_c)
                except TypeError:
                    # aval mismatch the shape check couldn't see (e.g. an
                    # unexpected input dtype): traced dispatch handles it
                    pass
        if single_window:
            # Default path: the whole chunk pipeline (gather -> decompose
            # -> filter/pack -> project) is ONE compiled program; with a
            # mesh it is shard_map'd over the block axis (data parallel).
            if mesh is not None:
                from localmd_tpu.parallel.sharded import (
                    sharded_window0_chunk_step,
                )

                acc_c, counts_c, v_c = sharded_window0_chunk_step(
                    mesh, data_crop, starts_batch, keys_batch, b1, b2,
                    max_components, temporal_avg_factor, spatial_avg_factor,
                    spatial_threshold, temporal_threshold,
                    max_consecutive_failures, sden, tden,
                    t_used=crop_avg_constant,
                )
            else:
                acc_c, counts_c, v_c = engine.window0_chunk_step(
                    data_crop, starts_batch, keys_batch, b1, b2,
                    max_components, temporal_avg_factor, spatial_avg_factor,
                    spatial_threshold, temporal_threshold,
                    max_consecutive_failures, sden, tden,
                    crop_avg_constant,
                )
            return engine.WindowedPMDResult(acc_c, counts_c, v_c)
        # Multi-window incremental-basis path: one compiled program
        # per chunk (device-side early-stop); with a mesh the block
        # axis is shard_map'd (see parallel.sharded.sharded_windowed_pmd).
        patch_batch = extract_patches(data_crop, starts_batch, b1, b2)
        if mesh is None and warmer is not None:
            compiled = warmer.get(
                patch_batch.shape,
                int(starts_batch.shape[0]),
                (b1, b2, max_components, temporal_avg_factor,
                 spatial_avg_factor, max_consecutive_failures, sden, tden,
                 crop_avg_constant, "multi", n_windows_global, wl_eff),
            )
            if compiled is not None:
                try:
                    acc_c, counts_c, v_c = warmer(
                        patch_batch, None, keys_batch,
                        spatial_threshold, temporal_threshold,
                    )
                    return engine.WindowedPMDResult(acc_c, counts_c, v_c)
                except TypeError:
                    pass
        return windowed_pmd_batched(
            patch_batch,
            keys_batch,
            window_len,
            max_components,
            spatial_threshold,
            temporal_threshold,
            max_consecutive_failures,
            temporal_avg_factor,
            spatial_avg_factor,
            sden,
            tden,
            mesh=mesh,
        )

    def _run_block_stage(bb):
        panels_chunks, counts_chunks, temporal_chunks = [], [], []
        for s in range(0, n_blocks, bb):
            idx = np.arange(s, min(s + bb, n_blocks))
            pad = bb - len(idx)
            idx_padded = (
                np.concatenate([idx, np.zeros(pad, dtype=int)]) if pad else idx
            )
            result = _dispatch_batch(idx_padded)
            sl = slice(0, len(idx))
            panels_chunks.append(result.spatial[sl])
            counts_chunks.append(result.counts[sl])
            temporal_chunks.append(result.temporal[sl])
        panels = jnp.concatenate(panels_chunks, axis=0)      # (N, p, S)
        counts = np.asarray(jnp.concatenate(counts_chunks))  # (N,) SYNC point
        v_blocks = jnp.concatenate(temporal_chunks, axis=0)  # (N, S, T_crop)
        return panels, counts, v_blocks

    def _run_block_stage_checkpointed(bb):
        """Per-BATCH checkpointing (the stage is hours for large FOVs, and
        batches are its natural unit): every finished batch persists its
        panels/counts/v slices with the block ids it covered under the run
        fingerprint, and a rerun recomputes ONLY the missing blocks — the
        batch dispatch takes arbitrary id lists, and the PRNG keys are
        pre-split per GLOBAL block id, so any partition of the remaining
        work is bit-identical to an undisturbed run."""
        parts = []  # (ids, panels_np, counts_np, v_np)
        for st in ckpt.matching_stages("blocks.part"):
            d = ckpt.load(st)
            parts.append((d["idx"], d["panels"], d["counts"], d["v_blocks"]))
        done = (
            np.concatenate([p[0] for p in parts])
            if parts
            else np.empty(0, np.int64)
        )
        missing = np.setdiff1d(np.arange(n_blocks), done)
        if done.size:
            display(
                f"Resuming block stage: {n_blocks - missing.size}/{n_blocks} "
                "blocks from per-batch checkpoints"
            )
        for s in range(0, missing.size, bb):
            idx = missing[s : s + bb]
            pad = bb - len(idx)
            idx_padded = (
                np.concatenate([idx, np.zeros(pad, dtype=int)]) if pad else idx
            )
            result = _dispatch_batch(idx_padded)
            sl = slice(0, len(idx))
            part = (
                np.asarray(idx),
                np.asarray(result.spatial[sl]),
                np.asarray(result.counts[sl]),
                np.asarray(result.temporal[sl]),
            )
            ckpt.save(
                f"blocks.part{int(idx[0]):06d}",
                idx=part[0], panels=part[1], counts=part[2], v_blocks=part[3],
            )
            parts.append(part)
        all_idx = np.concatenate([p[0] for p in parts])
        order = np.argsort(all_idx)
        panels = jnp.asarray(np.concatenate([p[1] for p in parts])[order])
        counts = np.concatenate([p[2] for p in parts])[order]
        v_blocks = jnp.asarray(np.concatenate([p[3] for p in parts])[order])
        return panels, counts, v_blocks

    if not blocks_ckpt:
        while True:
            try:
                stage_fn = (
                    _run_block_stage_checkpointed
                    if checkpoint_path is not None
                    else _run_block_stage
                )
                panels, counts, v_blocks = stage_fn(bb)
                break
            except Exception as e:  # noqa: BLE001
                # Free device memory can shrink between the budget probe
                # and execution. Halve the batch and redo the stage
                # (results are per-block, so a rerun is exact, and the PRNG
                # keys are pre-split per block — same seed, same sketches).
                # Multi-host: a one-sided OOM retry would diverge the SPMD
                # dispatch shapes across processes (deadlock) — re-raise.
                if not is_device_oom(e) or multi_host:
                    raise
                # drop any lingering references to the failed dispatch's
                # arrays before re-dispatching (the widefield OOM cascade:
                # the failed attempt's buffers outlived it into the retry)
                import gc

                gc.collect()
                new_bb = max(16, bb // 2)
                if mesh is not None:
                    # keep the retried batch shardable (shard_map requires
                    # the block axis divisible by the mesh size)
                    n_dev = mesh.devices.size
                    new_bb = ((new_bb + n_dev - 1) // n_dev) * n_dev
                if new_bb >= bb:
                    raise  # at the floor (16, or one mesh row) — can't shrink
                bb = new_bb
                display(
                    f"Device memory exhausted mid-stage; "
                    f"retrying blockwise decomposition in batches of {bb}"
                )
        ckpt.save(
            "blocks",
            panels=panels,
            counts=counts,
            v_blocks=v_blocks,
            temporal_basis_crop=temporal_basis_crop,
        )
        # the whole-stage checkpoint above supersedes the per-batch parts
        for st in ckpt.matching_stages("blocks.part"):
            ckpt.discard(st)
        # The filtered init movie is movie-sized HBM; everything after this
        # point works from the panels/temporal fits, and the streaming V pass
        # needs that HBM back (a 1024^2 x 1024 f32 movie is ~4.3 GB).
        data_crop = None


    # -- pyramid-weight + normalize + assemble U -------------------------------
    # Dispatched BEFORE the blocking counts pull below: none of it needs
    # total_rank, so the weighting/concat programs queue behind the block
    # stage and execute while the host waits out the D2H round trip.
    # weights_flat multiplies PANEL rows, whose within-block layout is always
    # F (see BlockGrid.rows); cum_flat is indexed by GLOBAL ids (order-aware).
    # Uploaded once per grid and cached (grid.device_constants).
    weights_flat, cum_flat, rows_dev, starts_dev = grid.device_constants()
    panels = panels * weights_flat[None, :, None]
    panels = panels / cum_flat[rows_dev][:, :, None]

    u = BlockSparseMatrix(
        panels=panels,
        rows=rows_dev,
        n_pixels=d1 * d2,
        dense_basis=jnp.asarray(load_obj.spatial_basis),
        starts=starts_dev,
        block_shape=(b1, b2),
        coset_info=grid.coset_info(),
        cell_geom=grid.cell_geometry(),
    )

    # V rows must mirror U's column layout: padded block slots then background.
    v_cropped = jnp.concatenate(
        [v_blocks.reshape(n_blocks * max_components, -1), temporal_basis_crop], axis=0
    )

    # Pre-dispatch the V-regression's packed cell operands (needs only U +
    # stats): the build executes under the counts pull / projector chain
    # below instead of delaying the second pass (loader stashes the result).
    from localmd_tpu.blocksparse import coset_vproj_eligible

    if not ckpt.has("v") and mesh is None and coset_vproj_eligible(u):
        load_obj.prepare_vproj_cells(u)

    total_rank = int(counts.sum())
    _mark("block_decomposition")
    display(f"Total blockwise rank (pre-background): {total_rank}")

    # -- factorized SVD / rank prune (reference decomposition.py:861-881) ------
    k_bg = u.dense_basis.shape[1]
    display(f"Rank before pruning: {total_rank + k_bg}")
    key, sub = jax.random.split(key)
    if rank_prune and (rank_prune_factor <= 0 or rank_prune_factor > 1):
        raise ValueError("rank_prune_factor must be in (0, 1]")

    # -- background warm of the downstream stages' programs --------------------
    # total_rank is on host now, so every later program shape is computable:
    # warm (dummy-execute at exact shapes, localmd_tpu.aot.StageWarmer) the
    # factorized-SVD eigensolver, the V-projection chunk kernel, and the
    # final-reformat SVD while the projector chain computes and the
    # V-regression pass streams. Shapes are predicted here by mirroring
    # compute_lowrank_factorized_svd's branch logic; after ``p`` exists the
    # same warms re-fire with exact shapes (deduped by name on a hit, so a
    # misprediction only costs one wasted dummy program).
    r_rows_w = int(v_cropped.shape[0])

    def _start_downstream_warms(k_val: int) -> None:
        if stage_warmer is None or mesh is not None or k_val <= 0:
            return

        def _warm_final():
            from localmd_tpu.ops.linalg import projected_svd

            return projected_svd(
                jnp.zeros((r_rows_w, k_val), jnp.float32),
                jnp.zeros((k_val, int(t_total)), jnp.float32),
            )

        stage_warmer.start(
            f"final:{k_val}", _warm_final,
            token=(r_rows_w, k_val, int(t_total)),
        )
        if not ckpt.has("v"):
            # READ dtype, not raw_dtype: TiffArray reads return float32
            # while its raw_dtype reports the on-disk dtype — the chunk
            # program's identity follows what v_projection actually
            # receives. The dummy chunk is bounded by the SAME
            # _stream_chunk_frames transient budget every chunked path
            # uses (HBM/16, 1 GiB floor).
            raw_dt = np.dtype(load_obj.dataset.dtype)
            chunk_t = int(min(load_obj._stream_chunk_frames(), t_total))

            from localmd_tpu.blocksparse import coset_vproj_eligible

            if coset_vproj_eligible(u):
                # mirror of the loader's coset dispatch (shared eligibility
                # helper): warm the operand fold + the chunk program at the
                # exact stage shapes
                pan_shape = tuple(u.panels.shape)
                k_bg_w = int(u.dense_basis.shape[1])
                geom_w = u.cell_geom
                r_rows_loc = r_rows_w

                def _warm_vproj_coset():
                    from localmd_tpu.blocksparse import (
                        build_vproj_cells,
                        coset_vproj_chunk,
                    )

                    m_cell, q = build_vproj_cells(
                        jnp.zeros(pan_shape, jnp.float32),
                        u.rows,
                        (d1, d2),
                        order,
                        geom_w,
                        jnp.zeros((d1 * d2, k_bg_w), jnp.float32),
                        jnp.ones((d1 * d2,), jnp.float32),
                        jnp.zeros((d1 * d2,), jnp.float32),
                    )
                    return coset_vproj_chunk(
                        m_cell, q,
                        jnp.zeros((r_rows_loc, k_val), jnp.float32),
                        jnp.zeros((chunk_t, d1, d2), raw_dt), *geom_w,
                        pan_shape[2],
                    )

                stage_warmer.start(
                    f"vproj-coset:{chunk_t}x{k_val}:{raw_dt.name}",
                    _warm_vproj_coset,
                    token=(pan_shape, chunk_t, k_val, raw_dt.name,
                           d1, d2, k_bg_w, geom_w, order, r_rows_loc),
                )
            else:
                def _warm_vproj():
                    from localmd_tpu.loader import _v_projection_kernel

                    return _v_projection_kernel(
                        jnp.zeros((d1 * d2, k_val), jnp.float32),
                        jnp.zeros((k_val,), jnp.float32),
                        jnp.zeros((chunk_t, d1, d2), raw_dt),
                        order,
                    )

                stage_warmer.start(
                    f"vproj:{chunk_t}x{k_val}:{raw_dt.name}", _warm_vproj,
                    token=(chunk_t, d1, d2, k_val, raw_dt.name, order),
                )

    if stage_warmer is not None and mesh is None and not ckpt.has("projector"):
        t_used_w = int(v_cropped.shape[1])
        if rank_prune:
            t_eff_w = int(min(total_rank + k_bg, t_used_w) * rank_prune_factor)
        else:
            t_eff_w = t_used_w
        m_quad_w = t_eff_w if r_rows_w > t_eff_w else r_rows_w
        k_w = min(total_rank + k_bg, m_quad_w)
        if m_quad_w > 0:
            from localmd_tpu.factorization import eigh_plan

            solver_w, k_sketch_w = eigh_plan(m_quad_w, k_w)

            def _warm_eigh():
                from localmd_tpu.ops.linalg import (
                    eigh_descending,
                    subspace_eigh,
                )

                q = jnp.zeros((m_quad_w, m_quad_w), jnp.float32)
                if solver_w == "subspace":
                    return subspace_eigh(q, k_sketch_w)
                return eigh_descending(q)

            stage_warmer.start(
                f"fsvd-eigh:{m_quad_w}x{k_sketch_w}", _warm_eigh,
                token=(m_quad_w, k_sketch_w, solver_w),
            )
            if u.banded_gram_ready(m_quad_w):
                # mirror of gram_quadratic's banded dispatch (shared
                # readiness helper, blocksparse.banded_gram_ready)
                pan_shape_g = tuple(u.panels.shape)
                k_bg_g = int(u.dense_basis.shape[1])
                geom_g = u.cell_geom

                def _warm_gram():
                    from localmd_tpu.blocksparse import _banded_gram_quad

                    return _banded_gram_quad(
                        jnp.zeros(pan_shape_g, jnp.float32),
                        jnp.zeros((r_rows_w, m_quad_w), jnp.float32),
                        jnp.zeros((d1 * d2, k_bg_g), jnp.float32),
                        u.rows,
                        *geom_g,
                    )

                stage_warmer.start(
                    f"fsvd-gram:{m_quad_w}x{pan_shape_g[0]}", _warm_gram,
                    token=(pan_shape_g, r_rows_w, m_quad_w, k_bg_g,
                           geom_g, d1, d2),
                )
        _start_downstream_warms(k_w)

    def _compute_projector():
        if ckpt.has("projector"):
            display("Resuming: mixing matrix loaded from checkpoint")
            return jnp.asarray(ckpt.load("projector")["p"])
        if rank_prune:
            min_dim = min(total_rank + k_bg, v_cropped.shape[1])
            random_mat = jax.random.normal(
                sub, (v_cropped.shape[1], int(min_dim * rank_prune_factor))
            )
            target_v = jnp.matmul(v_cropped, random_mat)
        else:
            target_v = v_cropped
        p_ = compute_lowrank_factorized_svd(
            u, target_v, only_left=True,
            # Under multi-host the panels were gathered to every process, so
            # the (small) Gram chain runs replicated per host — identical
            # inputs + identical programs = identical P on every process,
            # cheaper than a cross-host sharded Gram at these sizes.
            mesh=None if multi_host else mesh,
            expected_rank=total_rank + k_bg,
        )
        ckpt.save("projector", p=p_)
        return p_

    # -- projector + streaming temporal regression (second pass) + reformat ----
    # The three phases share one OOM-retry scope: every dispatch is async, so
    # a RESOURCE_EXHAUSTED raised anywhere in the Gram chain or
    # the regression surfaces at the first device sync (the checkpoint save or
    # the reformat's singular-value pull), leaving earlier arrays poisoned. On
    # OOM we drop the HBM movie cache (several GB back to a pressured chip),
    # recompute the projector from the same PRNG key (exact same sketch), and
    # re-stream the uncached frames from the dataset — same result, slower.
    if not ckpt.has("v"):
        # Start the V-regression's chunk stream (disk reads + async H2D on
        # the loader's prefetch thread) NOW: the host link is otherwise idle
        # while the projector chain below computes, so on streaming runs the
        # factorized-SVD stage's wall time comes off the second pass for
        # free. Identical results — this only moves transfer time.
        load_obj.start_v_prefetch(mesh=mesh)
    for attempt in (0, 1):
        try:
            p = _compute_projector()
            # p.shape[1] is an upper bound: the device-side top-k cut ZEROES
            # rank-deficient directions rather than dropping them (no host
            # sync on the critical path); true rank surfaces after
            # final_rank_tol pruning.
            display(f"Rank after reduction: <= {p.shape[1]}")
            # exact-shape warm of the V-projection kernel + final-reformat
            # SVD: loads hide behind the V-regression stream (no-op when
            # the predicted warm above already matched these shapes)
            _start_downstream_warms(int(p.shape[1]))
            _mark("factorized_svd")
            if ckpt.has("v"):
                display("Resuming: V regression loaded from checkpoint")
                v = jnp.asarray(ckpt.load("v")["v"])
                v_resumed = True
            else:
                display("Running streaming V regression over the full movie")
                v = load_obj.v_projection(u, p, mesh=mesh)
                if multi_host:
                    # frames-sharded global -> identical full host-local V
                    # on every process: the final reformat and the returned
                    # PMDArray are then ordinary local objects (V is small,
                    # rank x T)
                    from localmd_tpu.parallel.multihost import (
                        replicate_frame_sharded,
                    )

                    v = replicate_frame_sharded(v)
                v_resumed = False
            _mark("v_regression")
            display("Final SVD reformat")
            r, s_vals, vt, s_keep = final_svd_reformat(
                p, v, rel_tol=final_rank_tol
            )
            break
        except Exception as e:  # pragma: no cover - hardware OOM path
            if (
                not is_device_oom(e)
                or getattr(load_obj, "_cache", None) is None
                or attempt
                or multi_host  # one-sided retry would desync the processes
            ):
                raise
            display(
                "WARNING: factorized SVD / V regression hit device OOM; "
                "dropping the HBM movie cache and re-streaming"
            )
            load_obj.release_cache()  # also closes any pending V prefetch
            # Do NOT restart the eager V prefetch here: it would stage up to
            # depth x chunk-bytes of in-flight H2D buffers on the chip that
            # just raised RESOURCE_EXHAUSTED, during the final attempt before
            # the error is re-raised. v_projection streams on demand instead
            # (overlap is a luxury the retry path can't afford).
    if not v_resumed:
        # Saving on the resume path would re-pull the full (rank x T) matrix
        # D2H just to rewrite the identical file.
        ckpt.save("v", v=v)
    _mark("final_reformat")
    display(
        f"Matrix decomposition completed (final rank {int(s_keep.sum())})"
    )
    display(f"Stage timings (s): {timings}")

    out = PMDArray(
        u,
        r,
        s_vals,
        vt,
        load_obj.shape,
        order,
        load_obj.mean_img,
        load_obj.std_img,
        counts=counts,
        k2_keep=s_keep,
    )
    out.pipeline_timings = timings
    out.pipeline_cache = {
        "cached_frames": int(getattr(load_obj, "_cache_frames", 0)),
        "total_frames": int(t_total),
    }
    out.pipeline_aot = {
        "enabled": warmer is not None,
        "used": bool(warmer.used) if warmer is not None else False,
    }
    # stage warms COMPLETED by now (threads may still be draining for tiny
    # movies — purely diagnostic, the stages never wait on these). Tests
    # needing a deterministic view join via the live warmer handle.
    out.pipeline_warm = {
        "completed": list(stage_warmer.completed),
        "errors": {k: str(e) for k, e in stage_warmer.errors.items()},
    } if stage_warmer is not None else {"completed": [], "errors": {}}
    out._stage_warmer = stage_warmer
    out.pipeline_ranks = {
        "blockwise": int(total_rank),
        "pre_reduction": int(total_rank + k_bg),
        "reduced": int(p.shape[1]),
        "final": int(s_vals.shape[0]),
    }
    return out
