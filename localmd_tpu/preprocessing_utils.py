"""Drop-in namespace mirroring ``localmd.preprocessing_utils``.

Every symbol of the reference module (reference preprocessing_utils.py)
under its reference name, implemented by the batched kernels in
:mod:`localmd_tpu.ops.noise`. The ``*_vmap`` variants are the same batched
functions — they operate over leading dims, which matches the reference's
``vmap(..., in_axes=0)`` trace convention.

Note on semantics: these implement the DOCUMENTED 256-sample-segment Welch
(what the reference's hardcoded band indices intend). The reference's
*effective* runtime behavior (jax-welch with nperseg = len(trace)) is
available as :func:`welch_noise_estimate_ref_compat` / the pipeline's
``welch_compat="reference"`` mode.
"""

from localmd_tpu.ops.noise import (
    center,
    center_and_get_noise_estimate,
    center_and_noise_normalize,
    get_mean,
    get_mean_and_noise,
    get_mean_chunk,
    get_noise_estimate,
    standardize_block,
    welch_noise_estimate,
    welch_noise_estimate_ref_compat,
)

# reference vmap aliases (preprocessing_utils.py:40, :70, :81): the batched
# implementations already map over leading dims
get_noise_estimate_vmap = welch_noise_estimate
center_vmap = center
center_and_noise_normalize_vmap = center_and_noise_normalize

__all__ = [
    "get_mean_and_noise",
    "get_mean_chunk",
    "get_noise_estimate",
    "get_noise_estimate_vmap",
    "center_and_get_noise_estimate",
    "get_mean",
    "center",
    "center_vmap",
    "center_and_noise_normalize",
    "center_and_noise_normalize_vmap",
    "standardize_block",
    "welch_noise_estimate",
    "welch_noise_estimate_ref_compat",
]
