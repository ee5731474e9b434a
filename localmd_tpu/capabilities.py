"""Which fast path each backend platform runs: one table, keyed by
``jax.default_backend()``.

Every optional code path of the pipeline that is numerically equivalent to a
plainer one (but not bit-identical to it) is switched here:

- ``banded_gram``: the block-banded ``right^T (U^T U) right`` of the
  factorized SVD (``blocksparse._banded_gram_quad``) instead of the canvas
  form.
- ``coset_vproj``: the packed per-cell V-regression chunk kernel
  (``blocksparse.coset_vproj_chunk``) instead of the folded dense projector.
- ``aot_warm``: background compilation of later stages' programs while the
  statistics pass streams (``localmd_tpu.aot``).

The ``cpu`` row keeps every plain path, so CPU numerics (and the golden and
parity tests) never depend on a fast path. The ``gpu`` row is chosen from
end-to-end timings on an H100 (see PERF.md). A platform without a row is an
error, not a default: a new backend must be measured before it runs.

Module flags (``blocksparse.BANDED_GRAM``, ``blocksparse.COSET_VPROJ``)
and the pipeline's ``aot_warm=`` argument take ``True``/``False`` to force
a path and ``"auto"`` to read this table.
"""

from __future__ import annotations

import jax

FAST_PATHS = {
    "cpu": {
        "banded_gram": False,
        "coset_vproj": False,
        "aot_warm": False,
    },
    # H100, 512x512x2048 benchmark movie, 20 alternating on/off pairs of
    # warm end-to-end runs per entry (PERF.md, "Fast-path table"): the
    # banded Gram and the cell V-projection each save about 3 ms, more
    # than the row's interquartile range, in 19 and 20 of 20 pairs; and
    # background warm-compilation shortens cold runs.
    "gpu": {
        "banded_gram": True,
        "coset_vproj": True,
        "aot_warm": True,
    },
}


def fast_path(name: str) -> bool:
    """This backend's table entry for fast path ``name``."""
    platform = jax.default_backend()
    row = FAST_PATHS.get(platform)
    if row is None:
        raise RuntimeError(
            f"no fast-path table row for platform {platform!r} "
            f"(known: {sorted(FAST_PATHS)}); see localmd_tpu/capabilities.py"
        )
    return row[name]


def resolve(flag, name: str) -> bool:
    """A module flag's effective value: ``True``/``False`` force the path,
    ``"auto"`` reads :data:`FAST_PATHS` for the current backend."""
    if flag is True or flag is False:
        return flag
    if flag == "auto":
        return fast_path(name)
    raise ValueError(f"{name} flag must be True, False or 'auto', got {flag!r}")
