"""Background warm-compilation of pipeline stage programs.

Every distinct program pays a one-time compile (and load onto the device)
the first time a process calls it. Meanwhile the pipeline has long phases
in which the host link or the device is busy and no compilation is in
flight: the statistics pass and the V-regression pass are streaming, and
the factorized-SVD chain is device compute.

This module overlaps program compile+load with those phases, two ways:

- :class:`BlockProgramWarmer`: as soon as the loader commits to its HBM
  cache plan (the first thing its stats pass does), a daemon thread lowers
  + compiles the block-stage program (``engine.window0_chunk_step`` or the
  windowed multi-window loop) for the exact planned shapes, and the block
  stage dispatches through the AOT executable on a geometry match.
- :class:`StageWarmer`: later-stage programs (threshold Monte-Carlo,
  factorized-SVD eigensolver, V-projection chunk kernel, final-reformat
  SVD) are warmed by EXECUTING them on daemon threads — the real memoized
  computation where it is data-independent, zero-filled dummies at the
  exact stage shapes otherwise — as soon as each one's shapes are known
  (pipeline start; the block-stage counts sync; the projector's avals).

Correctness is never at stake: the precompiled executable IS the program
the traced call would build (same statics, same shapes), and it is used
only when the block stage's actual batch geometry matches the plan —
any mismatch (free-memory-dependent batch size, OOM-halved retries,
sharded/mesh runs) silently falls back to the ordinary traced dispatch.
A wrong plan therefore wastes a background compile, nothing more.

The reference has no equivalent (it has no AOT story); this is the
rebuild's own pipeline optimization. Whether it runs by default is the
``aot_warm`` entry of localmd_tpu.capabilities.FAST_PATHS.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from localmd_tpu import engine
from localmd_tpu.utils import get_logger

logger = get_logger()


def snapshot_jax_program_configs():
    """The caller's thread-local jax configs that are part of compiled-
    program identity (today: default matmul precision; the default device
    is snapshotted separately by each warmer since it is also a routing
    decision). Shared by both warmers so a future addition (e.g. a renamed
    config attr) cannot drift between them."""
    try:
        return jax.config.jax_default_matmul_precision
    except AttributeError:  # pragma: no cover - config name drift
        return None


@contextmanager
def replay_jax_program_configs(device, precision):
    """Re-enter the snapshotted configs on a worker thread. jax config
    contexts are THREAD-LOCAL: without this, a matmul_precision="highest"
    run would silently warm a default-precision (one-pass bf16) program —
    shape checks cannot see precision."""
    from contextlib import ExitStack

    with ExitStack() as stack:
        if device is not None:
            stack.enter_context(jax.default_device(device))
        if precision is not None:
            stack.enter_context(jax.default_matmul_precision(precision))
        yield


def normalized_init_geometry(shape, frame_range, window_chunks, block_sizes):
    """(frame_range_eff, window_chunks_eff, b1, b2) after the pipeline's
    deterministic pre-init clamp chain (mirrors localmd_decomposition's
    frame-sampling normalization — none of it consumes RNG). Shared by the
    block-stage planner and the threshold warm site so their mirrors of the
    pipeline cannot drift from each other. Raises ValueError when the FOV
    is smaller than the minimum block size (update_block_sizes)."""
    from localmd_tpu.ops.tiling import update_block_sizes

    t_total, d1, d2 = (int(x) for x in shape)
    fr = min(frame_range, t_total)
    wc = frame_range if window_chunks is None else window_chunks
    wc = min(wc, fr)
    b1, b2 = update_block_sizes(tuple(block_sizes), (d1, d2))
    return fr, wc, b1, b2


# Process-global warm registries. jit's trace/executable caches (and the
# AOT-compiled handles below) live for the whole process, so warming a
# given program is a ONCE-per-process affair — but every pipeline run
# constructs fresh warmer objects. Without these registries each WARM run
# re-paid the warm work: the StageWarmer re-EXECUTED its zero-filled
# dummies (redundant device time on every warm run) and the
# BlockProgramWarmer re-ran
# ``lower().compile()`` on a GIL-contending thread that the block stage
# then joins. Keys include the jax program-identity configs (precision)
# and the target device, matching replay_jax_program_configs.
_WARM_REGISTRY_LOCK = threading.Lock()
_STAGE_WARMED: set = set()
_BLOCK_PROGRAMS: dict = {}


def clear_warm_registry() -> None:
    """Drop all process-global warm records (tests/diagnostics). Running
    pipelines are unaffected — they hold their own references."""
    with _WARM_REGISTRY_LOCK:
        _STAGE_WARMED.clear()
        _BLOCK_PROGRAMS.clear()


class BlockProgramWarmer:
    """Compiles the window-0 chunk program on a background thread and hands
    it to the block stage if (and only if) the planned geometry matches.
    Compiled handles are kept in a process-global registry keyed by the
    full plan, so later runs of the same configuration skip the background
    lowering entirely (the block stage ``get`` otherwise joins a thread
    that is re-deriving an already-resident program)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._compiled = None
        self._plan = None
        self.used = False          # diagnostics: did the block stage hit?
        self.compile_error = None

    def start(
        self,
        *,
        d1: int,
        d2: int,
        t_data: int,
        bb: int,
        b1: int,
        b2: int,
        max_components: int,
        temporal_avg_factor: int,
        spatial_avg_factor: int,
        max_consecutive_failures: int,
        spatial_denoiser: Callable,
        temporal_denoiser: Callable,
        t_used: int,
        device=None,
        kind: str = "single",
        n_windows: int = 0,
        window_length: int = 0,
    ) -> None:
        """Begin compiling in the background for the given geometry.

        ``kind="single"`` compiles the fused window-0 chunk program (takes
        the whole init movie; gathers patches inside). ``kind="multi"``
        compiles the windowed incremental-basis loop program (takes a
        pre-gathered (bb, b1, b2, t_data) patch batch and per-(window,
        block) keys)."""
        if self._thread is not None:
            return
        self.kind = kind
        if kind == "multi":
            shape_key = (bb, b1, b2, t_data)
        else:
            shape_key = (d1, d2, t_data)
        self._plan = (
            shape_key, bb,
            (b1, b2, max_components, temporal_avg_factor, spatial_avg_factor,
             max_consecutive_failures, spatial_denoiser, temporal_denoiser,
             t_used, kind, n_windows, window_length),
        )

        precision = snapshot_jax_program_configs()
        reg_key = (self._plan, precision, str(device))
        with _WARM_REGISTRY_LOCK:
            cached = _BLOCK_PROGRAMS.get(reg_key)
        if cached is not None:
            # program already compiled+loaded this process: hand it over
            # without a thread (get() short-circuits on _thread presence,
            # so mark the slot with a pre-joined dummy)
            self._compiled = cached
            self._thread = threading.Thread(target=lambda: None)
            self._thread.start()
            return

        def _compile():
            try:
                if kind == "multi":
                    fn = engine._windowed_loop_jit(
                        n_windows, window_length, max_components,
                        temporal_avg_factor, spatial_avg_factor,
                        max_consecutive_failures,
                        spatial_denoiser, temporal_denoiser,
                    )
                    args = (
                        jax.ShapeDtypeStruct((bb, b1, b2, t_data), jnp.float32),
                        jax.ShapeDtypeStruct((n_windows, bb, 2), jnp.uint32),
                        jax.ShapeDtypeStruct((), jnp.float32),
                        jax.ShapeDtypeStruct((), jnp.float32),
                    )
                else:
                    fn = engine.window0_chunk_step
                    args = (
                        jax.ShapeDtypeStruct((d1, d2, t_data), jnp.float32),
                        jax.ShapeDtypeStruct((bb, 2), jnp.int32),
                        jax.ShapeDtypeStruct((bb, 2), jnp.uint32),
                        b1, b2, max_components,
                        temporal_avg_factor, spatial_avg_factor,
                        jax.ShapeDtypeStruct((), jnp.float32),
                        jax.ShapeDtypeStruct((), jnp.float32),
                        max_consecutive_failures,
                        spatial_denoiser, temporal_denoiser, t_used,
                    )
                with replay_jax_program_configs(device, precision):
                    self._compiled = fn.lower(*args).compile()
                with _WARM_REGISTRY_LOCK:
                    _BLOCK_PROGRAMS[reg_key] = self._compiled
            except Exception as e:  # noqa: BLE001 - warm-up must never kill a run
                self.compile_error = e
                logger.debug("background AOT compile failed: %s", e)

        self._thread = threading.Thread(
            target=_compile, name="localmd-aot-warm", daemon=True
        )
        self._thread.start()

    def get(self, data_shape, batch_size: int, statics: tuple):
        """The compiled program if it matches the actual block-stage
        geometry AND static arguments (joining the background thread
        first), else None. The statics check matters: a mismatched
        max_components would change the program's OUTPUT shapes, not just
        its speed."""
        if self._thread is None:
            return None
        # plan check BEFORE join: a mispredicted plan must not stall the
        # block stage behind a compile whose result will be discarded
        shape_p, bb, statics_p = self._plan
        if (
            tuple(data_shape) != shape_p
            or batch_size != bb
            or statics != statics_p
        ):
            return None
        self._thread.join()
        return self._compiled

    def __call__(self, data, starts, keys, spatial_threshold, temporal_threshold):
        """Dispatch through the precompiled executable. Thresholds may be
        host floats (checkpointed runs) or device scalars; AOT executables
        are strict about argument avals, so coerce to () float32.

        kind="single": ``data`` is the init movie, ``starts`` the patch
        offsets. kind="multi": ``data`` is the pre-gathered patch batch and
        ``starts`` is ignored (pass None)."""
        sthr = jnp.asarray(spatial_threshold, jnp.float32)
        tthr = jnp.asarray(temporal_threshold, jnp.float32)
        kind = getattr(self, "kind", "single")
        if kind == "multi":
            out = self._compiled(data, keys, sthr, tthr)
        else:
            out = self._compiled(data, starts, keys, sthr, tthr)
        self.used = True
        return out


class StageWarmer:
    """Warms later-stage pipeline programs on daemon threads by EXECUTING
    them — either the real (memoized) computation, or zero-filled dummies
    at the exact shapes the stage will use.

    Unlike :class:`BlockProgramWarmer`, which hands an AOT executable to its
    dispatch site, warming here relies on jit's process-global trace and
    executable caches: by the time the stage makes the identical call, the
    program is compiled AND loaded on the device, so the stage pays only
    compute. Otherwise the one-time per-process compile+load of each
    distinct program serializes with the pipeline's streaming passes
    instead of overlapping them.

    Results are never at stake: a dummy execution computes garbage that is
    thrown away (only the cache entry matters), the caller's thread-local
    jax configs (matmul precision, default device — both part of program
    identity) are replayed in the worker, and any failure is swallowed —
    the stage then pays its own compile+load, exactly as without warming.
    """

    def __init__(self, device=None):
        self._device = device
        self._threads: dict = {}
        self.completed: list = []
        self.errors: dict = {}

    def start(self, name: str, fn: Callable[[], object], token=None) -> None:
        """Run ``fn()`` on a daemon thread under the caller's jax configs.
        A second ``start`` with the same name is a no-op (warm sites may
        fire once on a shape prediction and again with exact shapes —
        include the shapes in ``name`` so only a mispredicted warm reruns).

        ``token``: hashable description of everything that determines the
        warmed program's identity beyond the display name (shapes, static
        geometry, dtypes). The process-global skip registry keys on it —
        an incomplete token would silently skip warming a DIFFERENT
        program that shares the name.
        """
        if name in self._threads:
            return
        precision = snapshot_jax_program_configs()
        device = self._device
        reg_key = (name, token, precision, str(device))
        with _WARM_REGISTRY_LOCK:
            if reg_key in _STAGE_WARMED:
                # warmed earlier this process: the executable cache is
                # process-global, so the program is already resident —
                # re-executing the dummy would only burn device time on
                # the warm path. Report it completed; join() stays a
                # no-op (self._threads holds no thread for it).
                self._threads[name] = None
                self.completed.append(name)
                return

        def _run():
            try:
                with replay_jax_program_configs(device, precision):
                    jax.block_until_ready(fn())
                self.completed.append(name)
                with _WARM_REGISTRY_LOCK:
                    _STAGE_WARMED.add(reg_key)
            except Exception as e:  # noqa: BLE001 - warming must never kill a run
                self.errors[name] = e
                logger.debug("stage warm %r failed: %s", name, e)

        t = threading.Thread(
            target=_run, name=f"localmd-warm-{name}", daemon=True
        )
        self._threads[name] = t
        t.start()

    def join(self, name: str, timeout: Optional[float] = None) -> None:
        """Wait for one warm to finish (no-op for names never started).
        Used where the stage's own call would redo the warm's exact work
        (the memoized threshold Monte-Carlo): joining reuses it instead of
        racing a duplicate computation."""
        t = self._threads.get(name)
        if t is not None:
            t.join(timeout)

    def join_all(self, timeout: Optional[float] = None) -> None:
        """Drain every warm thread (tests/diagnostics only — the pipeline
        never blocks on stray warms: a mispredicted warm may still be
        compiling)."""
        for t in list(self._threads.values()):
            if t is not None:      # None = registry-skipped (already warm)
                t.join(timeout)


def plan_block_stage(
    *,
    shape,
    frame_range: int,
    window_chunks: Optional[int],
    block_sizes,
    max_components: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    block_batch_size: int,
    cache_target_frames: int,
    cache_itemsize: int,
    device_resident_bytes: int,
    device,
) -> Optional[dict]:
    """Predict the block stage's geometry from quantities known BEFORE the
    statistics pass streams: dataset shape, the pipeline's deterministic
    clamp chain (mirrors localmd_decomposition's t_init / max_components /
    crop logic — none of it consumes RNG), and the loader's committed HBM
    cache plan. The returned dict's ``kind`` selects which program to warm:
    "single" (the fused window-0 chunk step) or "multi" (the windowed
    incremental-basis loop), with ``n_windows``/``window_length`` set for
    the latter.

    The prediction only gates a background warm-compile; the dispatch-time
    shape check in :meth:`BlockProgramWarmer.get` is what guarantees the
    precompiled program is byte-compatible with the actual call.
    """
    from localmd_tpu.ops.tiling import block_grid

    t_total, d1, d2 = (int(x) for x in shape)
    try:
        fr, wc, b1, b2 = normalized_init_geometry(
            shape, frame_range, window_chunks, block_sizes
        )
    except ValueError:
        return None
    if t_total < frame_range:
        t_init = t_total
    else:
        # identify_window_chunks emits num_intervals chunks of wc frames
        t_init = -(-frame_range // wc) * wc
    if temporal_avg_factor >= t_init:
        return None
    if t_init // temporal_avg_factor <= max_components:
        max_components = int(t_init // temporal_avg_factor)
    sketch_limit = min(
        t_init // temporal_avg_factor,
        (b1 // spatial_avg_factor + (b1 % spatial_avg_factor > 0))
        * (b2 // spatial_avg_factor + (b2 % spatial_avg_factor > 0)),
    ) - 10
    if max_components > sketch_limit:
        max_components = int(sketch_limit)
    if max_components <= 0:
        return None
    crop_avg_constant = (t_init // temporal_avg_factor) * temporal_avg_factor
    window_len = min(wc, crop_avg_constant)
    if window_len < crop_avg_constant:
        kind = "multi"
        wl_eff = engine.effective_window_length(
            window_len, crop_avg_constant, temporal_avg_factor
        )
        n_windows = len(range(0, crop_avg_constant, wl_eff))
    else:
        kind, wl_eff, n_windows = "single", 0, 0

    n_blocks = block_grid(d1, d2, (b1, b2)).n_blocks
    # the pipeline's batch-size budget — the SAME function the dispatch site
    # calls (utils.device.block_batch_budget), so plan and dispatch cannot
    # drift. At planning time the init crop / movie cache are not allocated
    # yet, so the predicted bytes are passed as pending.
    from localmd_tpu.utils.device import block_batch_budget

    per_block_bytes = b1 * b2 * crop_avg_constant * 4 * 4
    predicted_used = (
        d1 * d2 * crop_avg_constant * 4
        + cache_target_frames * d1 * d2 * cache_itemsize
        + device_resident_bytes
    )
    bb = block_batch_budget(
        device,
        per_block_bytes=per_block_bytes,
        n_blocks=n_blocks,
        block_batch_size=block_batch_size,
        pending_bytes=predicted_used,
    )
    return dict(
        d1=d1, d2=d2, t_data=t_init, bb=bb, b1=b1, b2=b2,
        max_components=max_components,
        crop_avg_constant=crop_avg_constant,
        kind=kind, n_windows=n_windows, window_length=wl_eff,
    )
