"""localmd_tpu — localized Penalized Matrix Decomposition in JAX.

A ground-up JAX/XLA re-design of the PMD compression/denoising
pipeline for functional neuroimaging movies (capability parity with the
reference ``localmd`` package; see SURVEY.md for the layer map).

Public surface mirrors the reference ``localmd/__init__.py`` (5 symbols)
plus extras (serialization helpers, datasets, sharded runner).
"""

from localmd_tpu.pipeline import localmd_decomposition
from localmd_tpu.factorization import compute_lowrank_factorized_svd
from localmd_tpu.ops.linalg import projected_svd
from localmd_tpu.pmd_array import PMDArray
from localmd_tpu.dataset import (
    PMDDataset,
    lazy_data_loader,
    TiffArray,
    NumpyArray,
    RawBinaryArray,
    NpyArray,
    ZStackArray,
    PlaneView,
    as_dataset,
)
from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.loader import PMDLoader
from localmd_tpu.serialization import save_decomposition, load_decomposition
from localmd_tpu.volumetric import VolumetricPMD, volumetric_decomposition
from localmd_tpu.dataset import DeviceMovie

# Bind the drop-in reference submodule namespaces as package attributes so
# `import localmd_tpu as localmd; localmd.decomposition...` (and the other
# reference import paths) work without a separate importlib step.
from localmd_tpu import (  # noqa: F401  (drop-in namespaces)
    decomposition,
    diagnostic_plots,
    evaluation,
    pmd_loader,
    pmdarray,
    preprocessing_utils,
)

__version__ = "0.3.0"

__all__ = [
    "localmd_decomposition",
    "compute_lowrank_factorized_svd",
    "projected_svd",
    "PMDArray",
    "TiffArray",
    "PMDDataset",
    "lazy_data_loader",
    "NumpyArray",
    "RawBinaryArray",
    "NpyArray",
    "ZStackArray",
    "PlaneView",
    "as_dataset",
    "BlockSparseMatrix",
    "PMDLoader",
    "save_decomposition",
    "load_decomposition",
    "VolumetricPMD",
    "volumetric_decomposition",
    "DeviceMovie",
]
