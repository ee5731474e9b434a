"""Ambient-device helpers.

Plane-parallel volumetric runs pin each plane's pipeline to its own chip via
``with jax.default_device(dev)`` (a thread-local config context). Code that
(a) keys per-device caches, (b) reads ``memory_stats`` to size HBM budgets,
or (c) stages host->device transfers from a helper thread must resolve the
device the SAME way jax placement will — the thread-local default when one
is set, the process default otherwise — or it reasons about (and transfers
to) the wrong chip.
"""

from __future__ import annotations

import jax


def ambient_device():
    """The jax default device set via ``jax.default_device`` (thread-local),
    or None when unset (process default placement)."""
    try:
        return jax.config.jax_default_device
    except AttributeError:  # config name drift across jax versions
        return None


def ambient_device_or_first():
    """The ambient default device, falling back to ``jax.devices()[0]`` —
    for memory_stats / budget probes that need a concrete device."""
    dev = ambient_device()
    return dev if dev is not None else jax.devices()[0]


_TRANSIENT_BUDGET_CACHE: dict = {}


def transient_budget_bytes(device=None) -> int:
    """Per-dispatch transient-buffer budget scaled to the device: HBM/16,
    floored at 1 GiB.

    The chunked paths (blocked-sparse matmuls, stream chunk sizing) bound
    their intermediates with this: every extra chunk costs a program
    dispatch, so a device with more memory gets fewer, larger chunks. HBM
    is read from ``memory_stats()``; devices without it (CPU test meshes)
    keep the 1 GiB floor so test behavior is hardware-independent.
    """
    dev = device if device is not None else ambient_device_or_first()
    key = getattr(dev, "id", None), getattr(dev, "device_kind", None)
    cached = _TRANSIENT_BUDGET_CACHE.get(key)
    if cached is not None:
        return cached
    hbm = None
    try:
        stats = dev.memory_stats()
        if stats and "bytes_limit" in stats:
            hbm = float(stats["bytes_limit"])
    except Exception:  # pragma: no cover - backend without memory_stats
        pass
    budget = max(1 << 30, int(hbm / 16)) if hbm else 1 << 30
    _TRANSIENT_BUDGET_CACHE[key] = budget
    return budget


def device_free_bytes(device, pending_bytes: int = 0):
    """FREE device memory from ``memory_stats()`` minus ``pending_bytes``
    (buffers that will be live at dispatch but are not yet allocated), or
    None when the runtime reports no memory statistics. Shared by the
    block-batch budget and the coset-stage memory gate."""
    try:
        stats = device.memory_stats()
    except Exception:  # pragma: no cover - backend without memory_stats
        return None
    if stats and "bytes_limit" in stats:
        return int(
            stats["bytes_limit"] - stats.get("bytes_in_use", 0) - pending_bytes
        )
    return None


def block_batch_budget(
    device,
    *,
    per_block_bytes: int,
    n_blocks: int,
    block_batch_size: int,
    pending_bytes: int = 0,
) -> int:
    """The block-stage batch size: the SINGLE source of truth shared by the
    pipeline's dispatch loop and the AOT planner (``aot.plan_block_stage``).

    Both sites previously carried their own copy of this formula; silent
    drift between them meant the stage warm never matched and the stage
    paid the cold compile again — so the budget lives here once.

    Bounds the batch so the fused chunk step's working set (patches + ~3
    same-sized intermediates = ``per_block_bytes`` each) fits: 40% of
    currently-free device memory when the runtime reports it (minus
    ``pending_bytes`` — buffers that WILL be live at dispatch but are not
    yet allocated at planning time; the dispatch site passes 0 because its
    buffers already show in ``bytes_in_use``); else a 1 GB floor. Bigger
    chunks = fewer program dispatches.

    Batch sizes below ``n_blocks`` are quantized down to a power of two:
    the batch size is a compiled-program shape, and free-memory jitter must
    not spawn new compile variants (bb == n_blocks stays: one chunk, no
    padding). Mesh divisibility rounding stays at the dispatch site.
    """
    budget = int(1e9)
    free = device_free_bytes(device, pending_bytes=pending_bytes)
    if free is not None:
        budget = max(budget, int(free * 0.4))
    bb = max(16, min(block_batch_size, n_blocks, budget // per_block_bytes))
    if bb < n_blocks:
        bb = 1 << (bb.bit_length() - 1)
    return int(bb)


def is_device_oom(e: BaseException) -> bool:
    """True iff ``e`` is the runtime's typed device-OOM error.

    The device-OOM retry scopes (stats pass, init-frame load, block stage,
    projector/V phase) must only retry genuine RESOURCE_EXHAUSTED failures:
    a bare ``"RESOURCE_EXHAUSTED" in str(e)`` would also match user
    exceptions that merely quote the word, and silently matching on message
    text alone is brittle across jaxlib rewordings of *other* errors. So:
    the exception must be the runtime's typed error (``jax.errors.
    JaxRuntimeError``, the public alias of jaxlib's XlaRuntimeError) AND
    carry the canonical absl status-code token, which is the stable
    machine-readable part of the message (jaxlib prefixes every status-based
    error with its code name)."""
    try:
        from jax.errors import JaxRuntimeError
    except ImportError:  # pragma: no cover - ancient jax
        JaxRuntimeError = ()
    return isinstance(e, JaxRuntimeError) and "RESOURCE_EXHAUSTED" in str(e)
