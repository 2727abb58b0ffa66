"""
Rolling (sliding-window) statistics as JAX device kernels.

The reference computes rolling mean/std/var with pandas (pd.rolling_* in
construct.py:446-448, detect.py:567-568, fas.py:126-127) on host. Here they
are cumsum-based device ops.

Precision note (the device path is float32): a naive cumsum over a
million-sample chunk loses ~1e-4 relative precision in f32. All rolling
sums here subtract the array mean before the cumsum and add ``n * mean``
back per window, so the cumsum stays a zero-mean random walk (O(sqrt(L))
magnitude) and window sums keep ~1e-7 relative accuracy without needing
f64.

Note the reference multiplies pandas' sample std by sqrt((n-1)/n)
(construct.py:448), i.e. uses *population* statistics — these kernels
compute population mean/var/std directly.
"""
from __future__ import annotations

import jax.numpy as jnp


def rolling_sum(x, n):
    """Sliding-window sum, output length ``len(x) - n + 1``."""
    x = jnp.asarray(x)
    m = jnp.mean(x)
    c = jnp.cumsum(x - m)
    head = c[n - 1]
    body = c[n:] - c[:-n]
    return jnp.concatenate([head[None], body]) + n * m


def rolling_mean(x, n):
    """Sliding-window mean, output length ``len(x) - n + 1``."""
    return rolling_sum(x, n) / n


def rolling_sum_rows(x, n):
    """Batched sliding-window sums over the LAST axis: x [R, L] ->
    [R, L - n + 1]; ``vmap(rolling_sum)(x)`` as one batched prefix sum.

    Precision: rows are mean-centered before the prefix sum, so the cumsum
    stays an O(sqrt(L)) random walk (same trick as rolling_sum). (A
    two-level form with a triangular-matmul tile cumsum measured no faster
    on the GPU; PERF.md.)
    """
    mu = jnp.mean(x, axis=1, keepdims=True)
    C = jnp.cumsum(x - mu, axis=1)
    head = C[:, n - 1:n]
    body = C[:, n:] - C[:, :-n]
    return jnp.concatenate([head, body], axis=1) + n * mu


def window_stats_rows(xc, n_c, n):
    """Shared DS window statistics from demuxed rows xc [B, nc, L_c]:
    returns (a, power) [B, L_c - n_c + 1] — the per-window multiplexed
    mean and population power the DS finalize divides by (reference
    detect.py:566-568 semantics). One rolling_sum_rows call covers x and
    x^2 for every (chunk, channel) row."""
    B, nc, L_c = xc.shape
    flat = xc.reshape(B * nc, L_c)
    both = jnp.concatenate([flat, flat * flat], axis=0)
    sums = rolling_sum_rows(both, n_c)
    s1 = sums[:B * nc].reshape(B, nc, -1).sum(axis=1)   # [B, M]
    s2 = sums[B * nc:].reshape(B, nc, -1).sum(axis=1)
    a = s1 / n
    var_samp = (s2 - s1 * s1 / n) / (n - 1.0)
    power = jnp.maximum(var_samp, 0.0) * n
    return a, power


def rolling_mean_var(x, n):
    """Sliding-window population mean and variance (ddof=0).

    Matches ``pd.rolling_var(x, n) * (n-1)/n`` as used by the reference DS
    kernel (detect.py:568 multiplies the rolling var by n to get power; the
    pandas var there is sample var but the xcorr kernel corrects to
    population — we standardize on population everywhere and carry the
    correction in callers when matching the reference exactly).
    """
    mu = rolling_mean(x, n)
    m2 = rolling_mean(x * x, n)
    var = jnp.maximum(m2 - mu * mu, 0.0)
    return mu, var


def rolling_std(x, n):
    """Sliding-window population std."""
    _, var = rolling_mean_var(x, n)
    return jnp.sqrt(var)


def rolling_mean_centered(x, n):
    """
    Centered rolling mean matching ``pd.rolling_mean(x, n, center=True)``:
    positions without a full window are NaN. Output has the same length as
    the input. Used by the STA/LTA of the detection statistic
    (detect.py:501-514).

    pandas centers the label at offset ``(n-1)//2 + 1``... empirically the
    trailing window result at index i (covering x[i-n+1 : i+1]) is labeled at
    index ``i - ((n-1) // 2)`` by pandas; we reproduce that.
    """
    x = jnp.asarray(x)
    L = x.shape[0]
    mu = rolling_mean(x, n)  # length L - n + 1, value k covers x[k:k+n]
    out = jnp.full((L,), jnp.nan, dtype=x.dtype)
    # trailing result k is labeled at center index k + n - 1 - ((n-1)//2)
    start = (n - 1) - ((n - 1) // 2)
    out = out.at[start:start + mu.shape[0]].set(mu)
    return out
