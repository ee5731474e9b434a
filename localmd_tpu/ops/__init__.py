from localmd_tpu.ops.linalg import (
    truncated_random_svd,
    batched_truncated_random_svd,
    svd_gram_left,
    svd_gram_right,
    projected_svd,
    eigh_descending,
)
from localmd_tpu.ops.noise import (
    welch_noise_estimate,
    get_mean_and_noise,
    center,
    center_and_noise_normalize,
    standardize_block,
    center_and_get_noise_estimate,
)
from localmd_tpu.ops.roughness import (
    spatial_roughness_stat,
    temporal_roughness_stat,
    evaluate_fitness,
    filter_by_failures,
    filter_by_failures_np,
    l1_norm,
    trend_filter_stat,
    total_variation_stat,
)
from localmd_tpu.ops.pooling import downsample_average_pooling

__all__ = [
    "truncated_random_svd",
    "batched_truncated_random_svd",
    "svd_gram_left",
    "svd_gram_right",
    "projected_svd",
    "eigh_descending",
    "welch_noise_estimate",
    "get_mean_and_noise",
    "spatial_roughness_stat",
    "temporal_roughness_stat",
    "evaluate_fitness",
    "filter_by_failures",
    "filter_by_failures_np",
    "downsample_average_pooling",
    "center",
    "center_and_noise_normalize",
    "standardize_block",
    "center_and_get_noise_estimate",
    "l1_norm",
    "trend_filter_stat",
    "total_variation_stat",
]
