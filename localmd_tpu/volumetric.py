"""Multi-plane (volumetric) PMD: decompose each z-plane independently.

BASELINE.json config 5: multi-plane volumetric stack, per-plane PMD sharded
across a device mesh. Each plane is an independent PMD problem; planes share
compiled programs (identical shapes), so after the first plane compiles,
subsequent planes run at steady-state throughput.

Returns a :class:`VolumetricPMD` holding one PMDArray per plane with a
4-D array-like view (t, z, d1, d2).
"""

from __future__ import annotations

from typing import List

import numpy as np

from localmd_tpu.dataset import ZStackArray, as_dataset
from localmd_tpu.pipeline import localmd_decomposition
from localmd_tpu.pmd_array import PMDArray
from localmd_tpu.utils import display


class VolumetricPMD:
    """Array-like view over per-plane PMD decompositions: (T, Z, d1, d2)."""

    def __init__(self, planes: List[PMDArray]):
        if not planes:
            raise ValueError("need at least one plane")
        self.planes = planes
        s0 = planes[0].shape
        for p in planes[1:]:
            if p.shape != s0:
                raise ValueError("planes must share shape")

    @property
    def n_planes(self) -> int:
        return len(self.planes)

    @property
    def shape(self):
        t, d1, d2 = self.planes[0].shape
        return (t, self.n_planes, d1, d2)

    @property
    def ndim(self) -> int:
        return 4

    @property
    def dtype(self):
        return np.float32

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        t_key = key[0] if len(key) > 0 else slice(None)
        z_key = key[1] if len(key) > 1 else slice(None)
        rest = key[2:]
        z_indices = np.arange(self.n_planes)[z_key]
        z_indices = np.atleast_1d(z_indices)
        per_plane = []
        for z in z_indices:
            sub_key = (t_key,) + rest if rest else (t_key,)
            sub_key = sub_key if len(sub_key) <= 3 else sub_key[:3]
            plane = self.planes[int(z)]
            # Pipeline-built planes hold live device factors: slice each
            # plane ON-CHIP (batched panel matmul over intersecting blocks,
            # PMDArray._getitem_device) — never the CSR export, which would
            # pull every plane's full factor set device->host (BASELINE
            # north star; the 2-D path got this in round 4, reference
            # pmdarray.py:132-171 semantics per plane).
            if plane._blocksparse is not None:
                frame = plane._getitem_device(sub_key)
            else:
                frame = plane._getitem_host(sub_key)
            per_plane.append(frame)
        out = np.stack(per_plane, axis=1)  # (t, z, ...)
        return out.squeeze().astype(np.float32)

    def save(self, filename_prefix: str) -> List[str]:
        paths = []
        for z, plane in enumerate(self.planes):
            path = f"{filename_prefix}_plane{z}.npz"
            plane.to_npz(path)
            paths.append(path)
        return paths

    def close(self, materialize: bool = True) -> None:
        """Release every plane's device (HBM) buffers — see
        :meth:`PMDArray.close`. A volumetric result holds N planes of
        factors on device; freeing them previously required a manual loop."""
        for plane in self.planes:
            plane.close(materialize=materialize)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def volumetric_decomposition(
    stack,
    block_sizes,
    frame_range: int,
    devices=None,
    **kwargs,
) -> VolumetricPMD:
    """Run PMD per plane of a volumetric stack.

    Two orthogonal scale-out axes (BASELINE.json config 5, per-plane PMD
    sharded across a device mesh):

    - ``mesh=`` (forwarded to each plane's pipeline): ONE plane at a time,
      its block grid and streaming V regression shard_map'd across the mesh
      — right when planes are large relative to a chip.
    - ``devices=`` (a list of jax devices): planes round-robin onto devices
      and run CONCURRENTLY, one host thread per device, zero cross-device
      traffic — right when there are at least as many planes as chips.
      Seeded runs stay deterministic (each plane draws from its own local
      RandomState) and equal the sequential result. Mutually exclusive with
      ``mesh``.

    With ``checkpoint_path=``, each plane checkpoints independently at
    ``{checkpoint_path}_plane{z}`` (a shared path would make plane z resume
    from plane 0's stages: the resume fingerprint covers config, not data).

    Args:
        stack: ZStackArray, or a sequence of per-plane (T, d1, d2) movies
            (numpy / jax / PMDDataset each).
        devices: optional list of jax devices for plane-parallel execution.
        Remaining args as :func:`localmd_tpu.pipeline.localmd_decomposition`.
    """
    if isinstance(stack, ZStackArray):
        planes = stack.planes
    elif isinstance(stack, (list, tuple)):
        planes = [as_dataset(p) for p in stack]
    else:
        raise TypeError("stack must be a ZStackArray or a sequence of planes")
    if devices and kwargs.get("mesh") is not None:
        raise ValueError(
            "devices= (plane-parallel) and mesh= (block-sharded) are mutually "
            "exclusive; pick one scale-out axis"
        )

    base_ckpt = kwargs.pop("checkpoint_path", None)

    def plane_kwargs(z):
        kw = dict(kwargs)
        if base_ckpt is not None:
            kw["checkpoint_path"] = f"{base_ckpt}_plane{z}"
        return kw

    if devices:
        import concurrent.futures as _cf

        import jax

        results: list = [None] * len(planes)

        def run_device(k):
            # One worker thread PER DEVICE, each processing planes k, k+D,
            # k+2D... sequentially: at most one full pipeline (movie cache +
            # working set) occupies a chip at a time. A shared FIFO pool
            # with z % D device picks would let a freed worker start the
            # next plane on a chip that is still running one (double-booked
            # HBM) while another chip idles.
            dev = devices[k]
            for z in range(k, len(planes), len(devices)):
                display(f"Decomposing plane {z + 1}/{len(planes)} on {dev}")
                with jax.default_device(dev):
                    results[z] = localmd_decomposition(
                        planes[z], block_sizes, frame_range, **plane_kwargs(z)
                    )

        with _cf.ThreadPoolExecutor(max_workers=len(devices)) as pool:
            futures = [
                pool.submit(run_device, k) for k in range(len(devices))
            ]
            for f in futures:
                f.result()
        return VolumetricPMD(results)

    results = []
    for z, plane in enumerate(planes):
        display(f"Decomposing plane {z + 1}/{len(planes)}")
        results.append(
            localmd_decomposition(
                plane, block_sizes, frame_range, **plane_kwargs(z)
            )
        )
    return VolumetricPMD(results)
