"""Quality-control diagnostics: correlation images + component browser.

Parity targets (reference diagnostic_plots.py):

- ``make_correlation_image``   (reference :227-272) — per-pixel max/mean
  correlation with the 8 spatial neighbors.
- ``make_autocorrelation_image`` (reference :275-305) — per-pixel lag-k
  autocorrelation.
- ``make_pmd_correlation_image`` / ``make_residual_correlation_image``
  (reference :163-224 / :101-160) — neighbor covariance of the PMD
  reconstruction / residual, scaled by the RAW movie's pixel variances so
  the three images are directly comparable.
- ``plot_pmd_components`` + ``construct_index`` (reference :363-473) —
  per-component HTML report browser.

Design: the reference computes every image with an O(d1*d2*8) host
Python loop around a tiny per-pair jit (reference :131-156, :195-220,
:249-269), with the whole movie in memory. Here every image is a STREAMED
accumulation: per-pixel sums / squared sums / 8 shifted cross-products are
additive over frame chunks, so one jitted accumulate per chunk + one
finalize program produce the image in bounded memory (one chunk + a dozen
images on device) — QC works on from-disk movies far larger than HBM, and
a PMDArray source is reconstructed on device chunk by chunk. Numerical
quirks preserved: covariance uses ddof=1 (jnp.cov), the variance scaling
uses ddof=0 (jnp.var), and "max" mode is floored at 0 by the reference's
zero-initialized accumulator.

Rendering: plotly is used if installed (reference dependency); otherwise
matplotlib renders equivalent figures into self-contained HTML (base64 PNG).
"""

from __future__ import annotations

import base64
import io
import os
import re
from functools import partial


import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

try:  # pragma: no cover - environment dependent
    import plotly  # noqa: F401

    _HAVE_PLOTLY = True
except ImportError:
    _HAVE_PLOTLY = False

# The 8 spatial neighbor offsets.
_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _valid_mask(d1: int, d2: int, dy: int, dx: int):
    """Pixels whose (dy, dx) neighbor exists (jnp.roll wraps; wrapped
    positions are masked out at finalize)."""
    yy = jnp.arange(d1)[:, None]
    xx = jnp.arange(d2)[None, :]
    return (yy - dy >= 0) & (yy - dy < d1) & (xx - dx >= 0) & (xx - dx < d2)


def _neighbor_reduce(products, valids, mode: str):
    """Combine 8 (d1, d2) neighbor statistics into one image."""
    stacked = jnp.stack(products)           # (8, d1, d2)
    masks = jnp.stack(valids)
    if mode == "mean":
        return jnp.sum(stacked * masks, axis=0) / jnp.sum(masks, axis=0)
    if mode == "max":
        # reference accumulator starts at 0 => negative values floor at 0
        return jnp.max(jnp.where(masks, stacked, 0.0), axis=0).clip(min=0.0)
    raise ValueError(f"mode {mode} not supported")


DEFAULT_CHUNK_FRAMES = 1024


def _n_frames(source) -> int:
    return int(source.shape[0])


def _load_frames(source, a: int, b: int) -> Array:
    """(b - a, d1, d2) float32 device frames from any movie source:
    np.ndarray, jax.Array, a PMDDataset/DeviceMovie, or a PMDArray (whose
    frames are reconstructed ON DEVICE chunk by chunk — the whole denoised
    movie is never materialized)."""
    from localmd_tpu.pmd_array import PMDArray

    if isinstance(source, PMDArray):
        return source.reconstruct_frames(np.arange(a, b)).astype(jnp.float32)
    chunk = source[slice(a, b)]
    return jnp.asarray(chunk).astype(jnp.float32)


def _chunk_spans(t: int, chunk_frames: int):
    return [(a, min(a + chunk_frames, t)) for a in range(0, t, chunk_frames)]


# -- streaming moment accumulators -------------------------------------------
#
# All three QC images reduce to per-pixel sums that are additive over frame
# chunks: S1 = sum x, S2 = sum x^2, and the 8 shifted cross-products
# C_k = sum x * shift_k(x). Correlation and covariance are invariant to a
# per-pixel constant shift, so chunks are accumulated relative to a reference
# image (the first chunk's mean) — this keeps the S2 - T*m^2 cancellation
# benign in float32 even for high-offset uint16 movies. The reference
# implementation instead column-batches a host loop over all pixels with the
# whole movie in memory (reference diagnostic_plots.py:227-305).


def _crosses(y, acc):
    """Accumulate the 8 shifted cross-product images of ``y`` into ``acc``."""
    updates = []
    for i, (dy, dx) in enumerate(_SHIFTS):
        updates.append(acc[i] + jnp.sum(y * jnp.roll(y, (dy, dx), axis=(1, 2)), axis=0))
    return jnp.stack(updates)


@jax.jit
def _moment_update(s1, s2, cross, chunk, ref):
    x = chunk - ref
    s1 = s1 + jnp.sum(x, axis=0)
    s2 = s2 + jnp.sum(x * x, axis=0)
    return s1, s2, _crosses(x, cross)


def _accumulate_moments(source, chunk_frames: int):
    """Stream a movie source once; return (T, ref, S1, S2, C[8])."""
    t = _n_frames(source)
    d1, d2 = source.shape[1], source.shape[2]
    s1 = jnp.zeros((d1, d2), jnp.float32)
    s2 = jnp.zeros((d1, d2), jnp.float32)
    cross = jnp.zeros((8, d1, d2), jnp.float32)
    ref = None
    for a, b in _chunk_spans(t, chunk_frames):
        chunk = _load_frames(source, a, b)
        if ref is None:
            ref = jnp.mean(chunk, axis=0)
        s1, s2, cross = _moment_update(s1, s2, cross, chunk, ref)
    return t, ref, s1, s2, cross


@partial(jax.jit, static_argnums=(4, 5))
def _corr_finalize(s1, s2, cross, t, mode, shape):
    d1, d2 = shape
    m = s1 / t
    norm = jnp.sqrt(jnp.maximum(s2 - t * m * m, 0.0))
    products, valids = [], []
    for i, (dy, dx) in enumerate(_SHIFTS):
        ms = jnp.roll(m, (dy, dx), axis=(0, 1))
        norms = jnp.roll(norm, (dy, dx), axis=(0, 1))
        products.append((cross[i] - t * m * ms) / (norm * norms))
        valids.append(_valid_mask(d1, d2, dy, dx))
    return _neighbor_reduce(products, valids, mode)


def make_correlation_image(
    movie, mode: str = "max", chunk_frames: int = DEFAULT_CHUNK_FRAMES
) -> np.ndarray:
    """Per-pixel neighbor correlation. (T, d1, d2) source -> (d1, d2).

    Streams the movie in ``chunk_frames`` chunks (bounded memory: one chunk
    + a dozen images on device), so it works on from-disk datasets far
    larger than HBM. Reference equivalent: diagnostic_plots.py:227-272.
    """
    t, _, s1, s2, cross = _accumulate_moments(movie, chunk_frames)
    d1, d2 = movie.shape[1], movie.shape[2]
    return np.asarray(_corr_finalize(s1, s2, cross, t, mode, (d1, d2)))


@partial(jax.jit, static_argnums=(0, 1))
def _autocorr_chunk_update(lag: int, n_tail: int, s1, s2, c, ext):
    """One fused program per chunk (an eager per-op loop would pay ~8
    dispatches per chunk). ``ext`` is the previous
    ``lag``-frame tail (already reference-subtracted) concatenated with the
    new offset chunk; ``n_tail`` leading frames are excluded from the
    moment sums (they were counted in the previous step)."""
    x = ext[n_tail:]
    s1 = s1 + jnp.sum(x, axis=0)
    s2 = s2 + jnp.sum(x * x, axis=0)
    c = c + jnp.sum(ext[:-lag] * ext[lag:], axis=0)
    return s1, s2, c, ext[-lag:]


@jax.jit
def _autocorr_finalize(s1, s2, c, head, tail, n):
    sa1 = s1 - jnp.sum(head, axis=0)          # frames [lag, T)
    sa2 = s2 - jnp.sum(head * head, axis=0)
    sb1 = s1 - jnp.sum(tail, axis=0)          # frames [0, T - lag)
    sb2 = s2 - jnp.sum(tail * tail, axis=0)
    ma, mb = sa1 / n, sb1 / n
    na = jnp.sqrt(jnp.maximum(sa2 - n * ma * ma, 0.0))
    nb = jnp.sqrt(jnp.maximum(sb2 - n * mb * mb, 0.0))
    return (c - n * ma * mb) / (na * nb)


def make_autocorrelation_image(
    movie, lag: int = 1, chunk_frames: int = DEFAULT_CHUNK_FRAMES
) -> np.ndarray:
    """Per-pixel lag-k autocorrelation, streamed in bounded memory.

    corr(movie[lag:], movie[:-lag]) per pixel, each side centered and
    normalized over its own frames (reference diagnostic_plots.py:275-305).
    A ``lag``-frame tail is carried between chunks so boundary-spanning
    pairs are counted exactly once.
    """
    t = _n_frames(movie)
    if t <= lag:
        raise ValueError(f"need more than lag={lag} frames, got {t}")
    chunk_frames = max(chunk_frames, 2 * lag)
    d1, d2 = movie.shape[1], movie.shape[2]

    s1 = jnp.zeros((d1, d2), jnp.float32)
    s2 = jnp.zeros((d1, d2), jnp.float32)
    c = jnp.zeros((d1, d2), jnp.float32)
    ref = head = tail = None
    for a, b in _chunk_spans(t, chunk_frames):
        chunk = _load_frames(movie, a, b)
        if ref is None:
            ref = jnp.mean(chunk, axis=0)
            head = chunk[:lag] - ref
            ext = chunk - ref
            n_tail = 0
        else:
            ext = jnp.concatenate([tail, chunk - ref], axis=0)
            n_tail = lag
        s1, s2, c, tail = _autocorr_chunk_update(lag, n_tail, s1, s2, c, ext)

    return np.asarray(_autocorr_finalize(s1, s2, c, head, tail, t - lag))


@partial(jax.jit, static_argnums=(5, 6))
def _scaled_cov_finalize(s1_t, cross_t, s1_r, s2_r, t, mode, shape):
    """Neighbor covariance of the target (ddof=1, jnp.cov parity) scaled by
    raw-pixel std products (ddof=0, jnp.var parity)."""
    d1, d2 = shape
    m_t = s1_t / t
    raw_std = jnp.sqrt(jnp.maximum(s2_r / t - (s1_r / t) ** 2, 0.0))
    products, valids = [], []
    for i, (dy, dx) in enumerate(_SHIFTS):
        ms = jnp.roll(m_t, (dy, dx), axis=(0, 1))
        rs = jnp.roll(raw_std, (dy, dx), axis=(0, 1))
        cov = (cross_t[i] - t * m_t * ms) / (t - 1)
        products.append(cov / (raw_std * rs))
        valids.append(_valid_mask(d1, d2, dy, dx))
    return _neighbor_reduce(products, valids, mode)


@jax.jit
def _scaled_cov_update(s1_t, cross_t, s1_r, s2_r, target_chunk, raw_chunk,
                       ref_t, ref_r):
    xt = target_chunk - ref_t
    xr = raw_chunk - ref_r
    s1_t = s1_t + jnp.sum(xt, axis=0)
    s1_r = s1_r + jnp.sum(xr, axis=0)
    s2_r = s2_r + jnp.sum(xr * xr, axis=0)
    return s1_t, _crosses(xt, cross_t), s1_r, s2_r


def _streamed_scaled_cov(
    original_movie, pmd_movie, mode: str, chunk_frames: int, residual: bool
) -> np.ndarray:
    t = _n_frames(original_movie)
    d1, d2 = original_movie.shape[1], original_movie.shape[2]
    s1_t = jnp.zeros((d1, d2), jnp.float32)
    cross_t = jnp.zeros((8, d1, d2), jnp.float32)
    s1_r = jnp.zeros((d1, d2), jnp.float32)
    s2_r = jnp.zeros((d1, d2), jnp.float32)
    ref_t = ref_r = None
    for a, b in _chunk_spans(t, chunk_frames):
        raw = _load_frames(original_movie, a, b)
        pmd = _load_frames(pmd_movie, a, b)
        target = raw - pmd if residual else pmd
        if ref_t is None:
            ref_t, ref_r = jnp.mean(target, axis=0), jnp.mean(raw, axis=0)
        s1_t, cross_t, s1_r, s2_r = _scaled_cov_update(
            s1_t, cross_t, s1_r, s2_r, target, raw, ref_t, ref_r
        )
    return np.asarray(
        _scaled_cov_finalize(s1_t, cross_t, s1_r, s2_r, t, mode, (d1, d2))
    )


def make_pmd_correlation_image(
    original_movie, pmd_movie, mode: str = "max",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
) -> np.ndarray:
    """Neighbor covariance of the PMD reconstruction scaled by raw variances.

    ``pmd_movie`` may be a dense (T, d1, d2) array or a ``PMDArray`` — the
    latter is reconstructed on device chunk by chunk, so QC runs in bounded
    memory on movies that don't fit HBM (reference equivalent:
    diagnostic_plots.py:163-224, column-batched host loop).
    """
    return _streamed_scaled_cov(
        original_movie, pmd_movie, mode, chunk_frames, residual=False
    )


def make_residual_correlation_image(
    original_movie, pmd_movie, mode: str = "max",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
) -> np.ndarray:
    """Neighbor covariance of (raw - PMD) scaled by raw variances — white
    residuals give a near-zero image (QC pass). Streams in bounded memory;
    ``pmd_movie`` may be a ``PMDArray`` (reference diagnostic_plots.py:101-160)."""
    return _streamed_scaled_cov(
        original_movie, pmd_movie, mode, chunk_frames, residual=True
    )


@partial(jax.jit, static_argnums=(0, 1))
def _qc_update(lag: int, first: bool, state, tail, raw, pmd,
               ref_r, ref_p, ref_d):
    """One fused program updating EVERY QC accumulator from one chunk pair."""
    (s1_r, s2_r, cr_r, s1_p, cr_p, s1_d, cr_d, c_auto) = state
    x = raw - ref_r
    p = pmd - ref_p
    d = (raw - pmd) - ref_d
    s1_r = s1_r + jnp.sum(x, axis=0)
    s2_r = s2_r + jnp.sum(x * x, axis=0)
    cr_r = _crosses(x, cr_r)
    s1_p = s1_p + jnp.sum(p, axis=0)
    cr_p = _crosses(p, cr_p)
    s1_d = s1_d + jnp.sum(d, axis=0)
    cr_d = _crosses(d, cr_d)
    ext = x if first else jnp.concatenate([tail, x], axis=0)
    c_auto = c_auto + jnp.sum(ext[:-lag] * ext[lag:], axis=0)
    return (s1_r, s2_r, cr_r, s1_p, cr_p, s1_d, cr_d, c_auto), ext[-lag:]


def compute_qc_images(
    original_movie,
    pmd_movie,
    mode: str = "max",
    lag: int = 1,
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
) -> dict:
    """All four QC images from ONE streaming sweep over the movie pair.

    The separate ``make_*`` functions each re-stream the raw movie (and
    re-reconstruct the PMDArray); the underlying moments are all additive,
    so this computes raw correlation, raw lag-``lag`` autocorrelation, PMD
    scaled covariance, and residual scaled covariance from a single pass —
    one chunk read + one on-device reconstruction per span, one fused
    update program. Returns a dict with keys ``correlation``,
    ``autocorrelation``, ``pmd_cov``, ``residual_cov``.
    """
    t = _n_frames(original_movie)
    if t <= lag:
        raise ValueError(f"need more than lag={lag} frames, got {t}")
    chunk_frames = max(chunk_frames, 2 * lag)
    d1, d2 = original_movie.shape[1], original_movie.shape[2]

    img = lambda: jnp.zeros((d1, d2), jnp.float32)
    stack = lambda: jnp.zeros((8, d1, d2), jnp.float32)
    state = (img(), img(), stack(), img(), stack(), img(), stack(), img())
    refs = head = tail = None
    for a, b in _chunk_spans(t, chunk_frames):
        raw = _load_frames(original_movie, a, b)
        pmd = _load_frames(pmd_movie, a, b)
        first = refs is None
        if first:
            refs = (
                jnp.mean(raw, axis=0),
                jnp.mean(pmd, axis=0),
                jnp.mean(raw - pmd, axis=0),
            )
            head = raw[:lag] - refs[0]
            tail = jnp.zeros((lag, d1, d2), jnp.float32)  # unused on first
        state, tail = _qc_update(lag, first, state, tail, raw, pmd, *refs)

    (s1_r, s2_r, cr_r, s1_p, cr_p, s1_d, cr_d, c_auto) = state
    return {
        "correlation": np.asarray(
            _corr_finalize(s1_r, s2_r, cr_r, t, mode, (d1, d2))
        ),
        "autocorrelation": np.asarray(
            _autocorr_finalize(s1_r, s2_r, c_auto, head, tail, t - lag)
        ),
        "pmd_cov": np.asarray(
            _scaled_cov_finalize(s1_p, cr_p, s1_r, s2_r, t, mode, (d1, d2))
        ),
        "residual_cov": np.asarray(
            _scaled_cov_finalize(s1_d, cr_d, s1_r, s2_r, t, mode, (d1, d2))
        ),
    }


# ---------------------------------------------------------------------------
# Figure rendering (plotly if present, else matplotlib -> standalone HTML)
# ---------------------------------------------------------------------------

def _mpl_fig_to_html(fig, title: str) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    data = base64.b64encode(buf.getvalue()).decode("ascii")
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body style='text-align:center'>"
        f"<h2>{title}</h2><img src='data:image/png;base64,{data}'/>"
        "</body></html>"
    )


def make_pmd_corr_diagnostic_plot(
    standard_correlation_image: np.ndarray,
    autocorr_image: np.ndarray,
    pmd_cov_image: np.ndarray,
    residual_cov_image: np.ndarray,
):
    """2x2 QC panel (raw corr / raw autocorr / PMD cov / residual cov).

    Returns a plotly figure if plotly is installed, else a matplotlib figure.
    """
    images = [
        ("Raw Corr", standard_correlation_image),
        ("Raw Autocorr", autocorr_image),
        ("Scaled Cov(UV)", pmd_cov_image),
        ("Scaled Cov(Y - UV)", residual_cov_image),
    ]
    vmax = float(np.amax(standard_correlation_image))
    if _HAVE_PLOTLY:  # pragma: no cover
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        fig = make_subplots(rows=2, cols=2, subplot_titles=[t for t, _ in images])
        for i, (_, img) in enumerate(images):
            fig.add_trace(
                go.Heatmap(z=np.array(img), coloraxis="coloraxis"),
                row=i // 2 + 1,
                col=i % 2 + 1,
            )
        fig.update_layout(
            title="Corr Images (PMD Weighted ACF(1) Image)",
            coloraxis=dict(colorscale="Viridis", cmin=0, cmax=vmax),
        )
        return fig

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 9))
    for ax, (name, img) in zip(axes.ravel(), images):
        im = ax.imshow(np.asarray(img), vmin=0, vmax=vmax, cmap="viridis")
        ax.set_title(name)
        ax.axis("off")
    fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.8)
    fig.suptitle("Corr Images (PMD Weighted ACF(1) Image)")
    return fig


def make_pmd_component_graph(
    spatial: np.ndarray,
    mean_img: np.ndarray,
    var_img: np.ndarray,
    trace: np.ndarray,
    index: int,
    title: str,
):
    """Per-component QC figure: mean / var / spatial images + temporal trace."""
    if _HAVE_PLOTLY:  # pragma: no cover
        import plotly.graph_objects as go
        import plotly.subplots as sp

        fig = sp.make_subplots(
            rows=2,
            cols=3,
            subplot_titles=["Mean", "Var Img", f"Spatial Comp {index}",
                            f"Temporal Comp {index}"],
            specs=[
                [{"type": "heatmap"}] * 3,
                [{"colspan": 3}, None, None],
            ],
        )
        for col, img in enumerate([mean_img, var_img, spatial], start=1):
            fig.add_trace(
                go.Heatmap(z=img, showscale=False, colorscale="Viridis"),
                row=1, col=col,
            )
        fig.add_trace(go.Scatter(y=trace, mode="lines", name="Signal"), row=2, col=1)
        fig.update_layout(title=title, height=800)
        return fig

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 8))
    names = ["Mean", "Var Img", f"Spatial Comp {index}"]
    for i, (name, img) in enumerate(zip(names, [mean_img, var_img, spatial])):
        ax = fig.add_subplot(2, 3, i + 1)
        ax.imshow(np.asarray(img), cmap="viridis")
        ax.set_title(name)
        ax.axis("off")
    ax = fig.add_subplot(2, 1, 2)
    ax.plot(np.asarray(trace))
    ax.set_title(f"Temporal Comp {index}")
    fig.suptitle(title)
    return fig


def plot_pmd_components(pmd_movie, folder: str, filename_prefix: str = "Component",
                        max_components: int | None = None):
    """Write one HTML QC page per component (reference :363-389).

    ``max_components`` caps the report at the top-N components by singular
    value (a high-rank decomposition can hold hundreds; rendering them all
    is rarely useful and costs ~1 s/page)."""
    if not os.path.exists(folder):
        raise ValueError(f"folder {folder} does not exist; create it first")

    u, r, s, v = pmd_movie.u, pmd_movie.r, pmd_movie.s, pmd_movie.v
    order = pmd_movie.order
    _, d1, d2 = pmd_movie.shape
    total_var = np.sum(np.square(s))

    n_render = r.shape[1] if max_components is None else min(r.shape[1], max_components)
    for i in range(n_render):
        comp = u.dot(r[:, i]).reshape((d1, d2), order=order)
        explained = np.square(s[i]) / total_var
        title = f"Comp {i}, Var explained {explained:3f}"
        name = f"{filename_prefix}_{i}.html"
        fig = make_pmd_component_graph(
            comp, pmd_movie.mean_img, pmd_movie.var_img, v[i, :], i + 1, title
        )
        path = os.path.join(folder, name)
        if _HAVE_PLOTLY:  # pragma: no cover
            fig.write_html(path)
        else:
            with open(path, "w") as f:
                f.write(_mpl_fig_to_html(fig, title))
            import matplotlib.pyplot as plt

            plt.close(fig)


def construct_index(folder: str, file_prefix: str = "Component",
                    index_name: str = "index.html") -> str:
    """Build a prev/next iframe browser over the per-component HTML pages."""

    def numerical_sort(fname):
        match = re.search(rf"{file_prefix}[_\s]*(\d+)", fname)
        return int(match.group(1)) if match else float("inf")

    html_files = sorted(
        (f for f in os.listdir(folder) if f.endswith(".html") and f != index_name),
        key=numerical_sort,
    )
    files_js = ",\n            ".join(f"'{f}'" for f in html_files)
    index_path = os.path.join(folder, index_name)
    with open(index_path, "w") as f:
        f.write(f"""<!DOCTYPE html>
<html lang="en">
<head>
  <meta charset="UTF-8">
  <title>PMD Component Browser</title>
  <style>
    body {{ font-family: sans-serif; margin: 20px; text-align: center; }}
    button {{ padding: 10px 20px; margin: 5px; font-size: 16px; }}
  </style>
</head>
<body>
  <h1>PMD Components</h1>
  <div id="content"><iframe src="" style="width:100%;height:640px;border:none"></iframe></div>
  <div>
    <button id="prev-btn" onclick="navigate(-1)">Previous</button>
    <span id="label"></span>
    <button id="next-btn" onclick="navigate(1)">Next</button>
  </div>
  <script>
    const files = [
            {files_js}
    ];
    let idx = 0;
    function load() {{
      document.getElementById('content').innerHTML =
        `<iframe src="${{files[idx]}}" style="width:100%;height:640px;border:none"></iframe>`;
      document.getElementById('label').textContent = `${{idx + 1}} / ${{files.length}}`;
      document.getElementById('prev-btn').disabled = idx === 0;
      document.getElementById('next-btn').disabled = idx === files.length - 1;
    }}
    function navigate(d) {{
      idx = Math.min(Math.max(idx + d, 0), files.length - 1);
      load();
    }}
    load();
  </script>
</body>
</html>
""")
    return index_path
