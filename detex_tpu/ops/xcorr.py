"""
Batched FFT normalized cross-correlation kernels.

Replaces the reference's O(N^2) Python pair loop (_makeDFcclags,
construct.py:369-394, calling _CCX2 at :425-466) with single batched device
calls: one rFFT per event, then all pairs correlated as one vmapped
elementwise-multiply + irFFT. Also provides the sliding normalized
correlation used for validation and magnitudes (fast_normcorr,
construct.py:469-483).

Semantics matched to the reference:
  - full-lag correlation c1 = [c[-(n-1):], c[:n]] (lags -(n-1)..(n-1))
  - channel-decimated striding ``[Nc-1::Nc]`` so multiplexed channels are
    never mixed (construct.py:452)
  - edge truncation ``trunc = n // (2*Nc) - 1`` samples on both ends
  - normalization by window population std and template std
  - values outside [-1, 1] (infs from zeroed windows) are zeroed
  - integer lag = (argmax + 1 + trunc) * Nc - n
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from detex_tpu.ops.rolling import rolling_mean, rolling_std
from detex_tpu.ops.subsample import subsample_shift


def next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def fft_len_for(n):
    """Reference FFT length: 2^bit_length(2n) (construct.py:672-674)."""
    return 2 ** int(2 * int(n)).bit_length()


def _pair_cc_one(Fi, Fj, a_j, b_j, sum_i, std_i, n, nc, nfft):
    """
    Correlate one pair given precomputed spectra and rolling stats of event
    j. Fi, Fj: [R] complex rffts; a_j, b_j: [2n-1] rolling mean/pop-std of
    the (n-1)-zero-padded event j; sum_i, std_i: scalars of event i.
    Returns (maxcc, lag_samples, subsamp) scalars.
    """
    trunc = n // (2 * nc) - 1
    c = jnp.fft.irfft(jnp.conj(Fi) * Fj, nfft)
    c1 = jnp.concatenate([c[nfft - (n - 1):], c[:n]])  # lags -(n-1)..(n-1)
    denom = n * b_j * std_i
    result = (c1 - sum_i * a_j) / jnp.where(denom == 0, jnp.nan, denom)
    result = result[nc - 1::nc]
    if trunc > 0:
        result = result[trunc:-trunc]
    # replace any |cc| > 1 (infs from zero-filled data) with 0
    bad = (result > 1.0) | (result < -1.0)
    result = jnp.where(bad, 0.0, result)
    allnan = jnp.all(jnp.isnan(result))
    safe = jnp.where(jnp.isnan(result), -jnp.inf, result)
    maxind = jnp.argmax(safe)
    maxcc = jnp.where(allnan, 0.0, safe[maxind])
    lag = (maxind + 1 + trunc) * nc - n
    lag = jnp.where(allnan, 0, lag)
    subs = jnp.where(allnan, 0.0,
                     subsample_shift(jnp.nan_to_num(result), maxind))
    return maxcc, lag, subs


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def _pairs_batch(Fi, Fj, a_j, b_j, sums_i, stds_i, n, nc, nfft):
    fn = lambda fi, fj, aj, bj, si, sdi: _pair_cc_one(  # noqa: E731
        fi, fj, aj, bj, si, sdi, n, nc, nfft)
    return jax.vmap(fn)(Fi, Fj, a_j, b_j, sums_i, stds_i)


def _pair_cc_strided(c1s, a_j, b_j, sum_i, std_i, n, nc):
    """
    Shared tail of the pair kernel operating directly in the strided
    (channel-aligned lag) domain: c1s [2*n_c-1] = the [Nc-1::Nc] stride of
    the full multiplexed correlation; a_j/b_j rolling stats at those
    offsets. Returns (maxcc, lag, subsamp).
    """
    trunc = n // (2 * nc) - 1
    denom = n * b_j * std_i
    result = (c1s - sum_i * a_j) / jnp.where(denom == 0, jnp.nan, denom)
    if trunc > 0:
        result = result[trunc:-trunc]
    bad = (result > 1.0) | (result < -1.0)
    result = jnp.where(bad, 0.0, result)
    allnan = jnp.all(jnp.isnan(result))
    safe = jnp.where(jnp.isnan(result), -jnp.inf, result)
    maxind = jnp.argmax(safe)
    maxcc = jnp.where(allnan, 0.0, safe[maxind])
    lag = (maxind + 1 + trunc) * nc - n
    lag = jnp.where(allnan, 0, lag)
    subs = jnp.where(allnan, 0.0,
                     subsample_shift(jnp.nan_to_num(result), maxind))
    return maxcc, lag, subs


@partial(jax.jit, static_argnames=("n", "nc", "nfft2"))
def _all_pairs_fused_demux(X, II, JJ, n, nc, nfft2):
    """
    Demultiplexed (polyphase) all-pairs kernel. The reference only keeps
    channel-aligned lags of the multiplexed correlation
    (``[Nc-1::Nc]``, construct.py:452), which decompose exactly into the
    sum of per-channel correlations — so each pair needs one irFFT of
    length nfft/Nc instead of nfft. Requires n % nc == 0.
    """
    N, n_full = X.shape
    n_c = n // nc
    Xc = X.reshape(N, n_c, nc).transpose(0, 2, 1)        # [N, nc, n_c]
    F = jnp.fft.rfft(Xc, nfft2, axis=-1)                 # [N, nc, R2]
    sums = jnp.sum(X, axis=-1)
    stds = jnp.std(X, axis=-1)
    # rolling stats of the (n_c-1)-zero-padded channels, summed over
    # channels == multiplexed window stats at channel-aligned offsets
    padc = jnp.pad(Xc, ((0, 0), (0, 0), (n_c - 1, n_c - 1)))
    s1 = jax.vmap(jax.vmap(lambda v: rolling_mean(v, n_c)))(padc)
    s2 = jax.vmap(jax.vmap(lambda v: rolling_mean(v * v, n_c)))(padc)
    S1 = s1.sum(1) * n_c                                  # [N, 2*n_c-1]
    S2 = s2.sum(1) * n_c
    a = S1 / n
    b = jnp.sqrt(jnp.maximum(S2 / n - a * a, 0.0))        # population std

    def one_batch(idx):
        ii, jj = idx
        # whole-batch cross-spectra + ONE batched inverse transform
        spec = jnp.sum(jnp.conj(F[ii]) * F[jj], axis=1)    # [P, R2]
        c = jnp.fft.irfft(spec, nfft2, axis=-1)
        c1s = jnp.concatenate([c[:, nfft2 - (n_c - 1):], c[:, :n_c]],
                              axis=1)
        return jax.vmap(
            lambda cs, aj, bj, si, sdi: _pair_cc_strided(
                cs, aj, bj, si, sdi, n, nc))(
            c1s, a[jj], b[jj], sums[ii], stds[ii])

    return jax.lax.map(one_batch, (II, JJ))


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def _all_pairs_fused(X, II, JJ, n, nc, nfft):
    """
    All pair batches in ONE device program: per-event precomputations,
    then a lax.map over pair batches with the gathers inside the program
    (a single dispatch instead of one host round trip per batch).

    X: [N, n] events; II/JJ: [nb, bsz] pair indices (padded).
    Returns (cc [nb, bsz], lag [nb, bsz], subsamp [nb, bsz]).
    """
    F = jnp.fft.rfft(X, nfft, axis=-1)
    sums = jnp.sum(X, axis=-1)
    stds = jnp.std(X, axis=-1)
    padded = jnp.pad(X, ((0, 0), (n - 1, n - 1)))
    a = jax.vmap(lambda x: rolling_mean(x, n))(padded)
    b = jax.vmap(lambda x: rolling_std(x, n))(padded)

    def one_batch(idx):
        ii, jj = idx
        fn = lambda i, j: _pair_cc_one(  # noqa: E731
            F[i], F[j], a[j], b[j], sums[i], stds[i], n, nc, nfft)
        return jax.vmap(fn)(ii, jj)

    return jax.lax.map(one_batch, (II, JJ))


def xcorr_all_pairs(X, nc, nfft=None, pair_batch=2048, dtype=jnp.float32):
    """
    All-pairs normalized xcorr of multiplexed event waveforms.

    Parameters
    ----------
    X : array [N, n]
        Multiplexed, equal-length event waveforms (host numpy ok).
    nc : int
        Number of interleaved channels.
    nfft : int or None
        FFT length; defaults to the reference's 2^bit_length(2n).
    pair_batch : int
        Pairs per device call (memory control).

    Returns
    -------
    (cc, lag, subsamp): [N, N] numpy arrays; upper triangle (i<j) filled,
    rest NaN (cc/subsamp) / 0 (lag), mirroring the reference DataFrames.
    """
    X = np.asarray(X)
    N, n = X.shape
    if nfft is None:
        nfft = fft_len_for(n)
    iu, ju = np.triu_indices(N, k=1)
    P = len(iu)
    cc = np.full((N, N), np.nan)
    lag = np.zeros((N, N))
    sub = np.full((N, N), np.nan)
    if P == 0:
        return cc, lag, sub
    bsz = min(pair_batch, P)
    nb = (P + bsz - 1) // bsz
    # pad the final batch (index (0, 1) repeats; results discarded)
    II = np.zeros(nb * bsz, dtype=np.int32)
    JJ = np.ones(nb * bsz, dtype=np.int32)
    II[:P] = iu
    JJ[:P] = ju
    if n % nc == 0:
        # polyphase fast path: per-pair irFFT of length nfft/nc
        nfft2 = fft_len_for(n // nc)
        mx, lg, sb = _all_pairs_fused_demux(
            jnp.asarray(X, dtype), jnp.asarray(II.reshape(nb, bsz)),
            jnp.asarray(JJ.reshape(nb, bsz)), int(n), int(nc), int(nfft2))
    else:
        mx, lg, sb = _all_pairs_fused(jnp.asarray(X, dtype),
                                      jnp.asarray(II.reshape(nb, bsz)),
                                      jnp.asarray(JJ.reshape(nb, bsz)),
                                      int(n), int(nc), int(nfft))
    cc[iu, ju] = np.asarray(mx).ravel()[:P]
    lag[iu, ju] = np.asarray(lg).ravel()[:P]
    sub[iu, ju] = np.asarray(sb).ravel()[:P]
    return cc, lag, sub


def ccx2(mptd1, mptd2, nc, nfft=None, dtype=jnp.float32):
    """
    Single-pair normalized xcorr: max cc, integer lag, subsample shift —
    the reference's _CCX2 (construct.py:425-466) as one device call.
    """
    X = np.stack([np.asarray(mptd1), np.asarray(mptd2)])
    cc, lag, sub = xcorr_all_pairs(X, nc, nfft=nfft, dtype=dtype)
    return cc[0, 1], lag[0, 1], sub[0, 1]


# ---------------------------------------------------------------------------
# Sliding normalized correlation (fast_normcorr)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nfft", "outlen"))
def _normcorr_bank_kernel(NT_fd, s_fd, sums, a, b, nfft, outlen):
    c = jnp.fft.irfft(jnp.conj(NT_fd) * s_fd[None, :], nfft,
                      axis=-1)[:, :outlen]
    return (c - sums[:, None] * a[None, :outlen]) / \
        jnp.where(b == 0, jnp.nan, b)[None, :outlen]


def normcorr_bank(T, s, dtype=jnp.float32):
    """Batched sliding normalized correlation ('valid' mode): templates
    T [K, n] against one series s [L] -> [K, L - n + 1]."""
    T = np.asarray(T)
    s = np.asarray(s)
    K, n = T.shape
    L = len(s)
    nfft = next_pow2(L + n)
    Td = jnp.asarray(T, dtype)
    sd = jnp.asarray(s, dtype)
    NT = (Td - jnp.mean(Td, axis=1, keepdims=True)) / \
        (jnp.std(Td, axis=1, keepdims=True) * n)
    a = rolling_mean(sd, n)
    b = rolling_std(sd, n)
    # correlation == convolution with reversed template; rfft of reversed
    # normalized template conj-multiplied with the series spectrum
    NT_fd = jnp.fft.rfft(NT, nfft, axis=-1)
    s_fd = jnp.fft.rfft(sd, nfft)
    out = _normcorr_bank_kernel(NT_fd, s_fd, jnp.sum(NT, axis=1), a, b,
                                int(nfft), int(L - n + 1))
    return np.asarray(out)


def normcorr(t, s, dtype=jnp.float32):
    """
    Normalized sliding correlation of template ``t`` against series ``s``
    (reference fast_normcorr, construct.py:469-483, including the swap when
    t is longer than s). Returns a length len(s)-len(t)+1 numpy array.
    """
    t = np.asarray(t)
    s = np.asarray(s)
    if len(t) > len(s):
        t, s = s, t
    return normcorr_bank(t[None, :], s, dtype=dtype)[0]
