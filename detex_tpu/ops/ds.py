"""
The subspace detection-statistic (DS) kernel — the framework's hot loop.

Reference semantics (_MPXDS detect.py:559-578 == _MPXSSCorr fas.py:120-134):
given a multiplexed continuous chunk ``x`` (length Lc) and a subspace basis
``U`` [D, n] (rows are orthonormal left singular vectors, or a normalized
single event):

    a    = rolling_mean(x, n)               # length Lc - n + 1
    p    = n * rolling_var(x, n)            # rolling power (pandas sample var
                                            #   * n in the reference; see note)
    c_d  = correlate(x, U_d)                # via FFT, valid part
    y_d  = c_d - sum(U_d) * a
    DS   = sum_d y_d^2 / p
    return DS[::Nc]                         # undo channel multiplexing

Note on the variance: the reference uses pandas *sample* var times n, i.e.
``sum((x-mu)^2) * n/(n-1)``. For orthonormal U the DS then peaks at
~(n-1)/n ≈ 1. We reproduce the reference exactly (sample var) so DS values
and thresholds are comparable to Detex's.

Numerics: the chunk is standardized (demeaned/scaled) on device first —
the DS is provably invariant to affine scaling of the data, and this keeps
float32 math accurate to ~1e-6 over million-sample chunks. Every float32 /
complex64 contraction states ``precision=HIGHEST``: a GPU would otherwise
run it in TF32 (about three significant digits), far outside the 2e-5 DS
envelope the engine's trigger gate relies on. Multiple chunks are processed
as a leading batch dimension, and a whole bank of detectors (same template
length) is evaluated with one batched irFFT.
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from detex_tpu.ops.rolling import rolling_mean, window_stats_rows

HIGHEST = jax.lax.Precision.HIGHEST


def hbm_budget(device=None):
    """Bytes a scan program may give its largest intermediate (the folded
    overlap-save inverse-transform output): a tenth of the device's
    memory limit (``memory_stats()["bytes_limit"]``), or 2 GiB where the
    device reports no limit (the CPU backend). The fold route's whole
    footprint is several times that intermediate (its complex spectra,
    the DS rows and their histogram sort): on an H100 an intermediate at
    an eighth of the limit peaked at 92% of it (PERF.md)."""
    dev = device if device is not None else jax.devices()[0]
    try:
        stats = dev.memory_stats() or {}
    except Exception:  # backends without memory stats
        stats = {}
    limit = stats.get("bytes_limit")
    return int(limit) // 10 if limit else 2 << 30


def required_fft_len(data_len_samps, n):
    """Reference required FFT length: 2^bit_length(reqlen)
    (detect.py:368-371, fas.py:147-148)."""
    return 2 ** int(int(data_len_samps) + int(n)).bit_length()


def prep_basis_fd(U, nfft, dtype=jnp.float32):
    """rFFT of reversed basis vectors at length nfft
    (reference _loadMPSubSpace detect.py:371, fas.py:171)."""
    U = jnp.asarray(U, dtype)
    return jnp.fft.rfft(U[..., ::-1], int(nfft), axis=-1)


def _ds_core(x, Ufd, sum_u, n, nc, nfft):
    """
    DS of one chunk against one subspace.
    x: [Lc] multiplexed data; Ufd: [D, R] rfft of reversed basis;
    sum_u: [D]. Returns [ceil((Lc - n + 1) / nc)].
    """
    Lc = x.shape[0]
    # standardize for f32 accuracy; DS is invariant to affine data transforms
    mu = jnp.mean(x)
    sd = jnp.std(x)
    xs = (x - mu) / jnp.where(sd == 0, 1.0, sd)

    a = rolling_mean(xs, n)                       # [Lc - n + 1]
    m2 = rolling_mean(xs * xs, n)
    var_pop = jnp.maximum(m2 - a * a, 0.0)
    power = var_pop * (n * n) / (n - 1.0)         # n * sample-var

    xfd = jnp.fft.rfft(xs, nfft)
    cc = jnp.fft.irfft(Ufd * xfd[None, :], nfft, axis=-1)[:, n - 1:Lc]
    y = cc - sum_u[:, None] * a[None, :]
    num = jnp.sum(y * y, axis=0)
    ds = num / jnp.where(power == 0, jnp.inf, power)
    return ds[::nc]


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def ds_single(x, Ufd, sum_u, n, nc, nfft):
    """Single chunk x [Lc], single subspace."""
    return _ds_core(x, Ufd, sum_u, n, nc, nfft)


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def ds_bank(x, Ufd, sum_u, d_mask, n, nc, nfft):
    """
    One chunk against a *bank* of S subspaces sharing template length n.
    x: [Lc]; Ufd: [S, Dmax, R]; sum_u: [S, Dmax]; d_mask: [S, Dmax] bool
    (False rows are zero-padded basis slots). Returns [S, out_len].
    """
    Lc = x.shape[0]
    mu = jnp.mean(x)
    sd = jnp.std(x)
    xs = (x - mu) / jnp.where(sd == 0, 1.0, sd)

    a = rolling_mean(xs, n)
    m2 = rolling_mean(xs * xs, n)
    var_pop = jnp.maximum(m2 - a * a, 0.0)
    power = var_pop * (n * n) / (n - 1.0)

    xfd = jnp.fft.rfft(xs, nfft)
    cc = jnp.fft.irfft(Ufd * xfd[None, None, :], nfft,
                       axis=-1)[:, :, n - 1:Lc]          # [S, Dmax, L']
    y = cc - sum_u[:, :, None] * a[None, None, :]
    y = jnp.where(d_mask[:, :, None], y, 0.0)
    num = jnp.sum(y * y, axis=1)                          # [S, L']
    ds = num / jnp.where(power == 0, jnp.inf, power)[None, :]
    return ds[:, ::nc]


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def ds_bank_chunks(X, Ufd, sum_u, d_mask, n, nc, nfft):
    """Batch over chunks: X [B, Lc] -> [B, S, out_len]."""
    return jax.vmap(lambda x: ds_bank(x, Ufd, sum_u, d_mask, n, nc, nfft))(X)


def make_bank(U_list, nfft, dtype=jnp.float32, min_dmax=0):
    """
    Pack a list of [D_i, n] basis arrays (equal n) into padded bank arrays.

    Returns dict with Ufd [S, Dmax, R], sum_u [S, Dmax], d_mask [S, Dmax],
    n, Dmax.
    """
    n = U_list[0].shape[1]
    assert all(u.shape[1] == n for u in U_list)
    S = len(U_list)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    U = np.zeros((S, Dmax, n), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    for i, u in enumerate(U_list):
        U[i, :u.shape[0]] = u
        mask[i, :u.shape[0]] = True
    Ufd = prep_basis_fd(U, nfft, dtype)
    sum_u = jnp.asarray(U.sum(axis=-1), dtype)
    return dict(Ufd=Ufd, sum_u=sum_u,
                d_mask=jnp.asarray(mask), n=int(n), Dmax=int(Dmax))


# ---------------------------------------------------------------------------
# Demultiplexed (polyphase) formulation — the production fast path.
#
# The DS is only evaluated at channel-aligned window starts (the reference's
# [::Nc] stride, detect.py:578). At those lags the multiplexed correlation
# decomposes exactly into a sum of per-channel correlations:
#     c_d(m*Nc) = sum_c corr(x_c, u_{d,c})[m]
# so instead of one length-nfft irFFT per basis over the interleaved stream,
# we do one length-(nfft/Nc) irFFT per basis of the channel-summed cross
# spectra — ~4x less FFT work and 3x smaller intermediate arrays, with
# bit-identical math (up to f32 rounding).
# ---------------------------------------------------------------------------


def make_bank_demux(U_list, nc, nfft2, dtype=jnp.float32, min_dmax=0):
    """
    Pack [D_i, n] multiplexed basis arrays into a demultiplexed bank:
    Ufd2 [S, Dmax, nc, R2] (rfft of reversed per-channel templates at
    nfft2), sum_u [S, Dmax], d_mask, n (multiplexed), n_c = n // nc.
    """
    n = U_list[0].shape[1]
    assert n % nc == 0, "template length must be a multiple of nc"
    S = len(U_list)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    n_c = n // nc
    Ud = np.zeros((S, Dmax, nc, n_c), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    sum_u = np.zeros((S, Dmax), dtype=np.float64)
    for i, u in enumerate(U_list):
        for d in range(u.shape[0]):
            Ud[i, d] = np.asarray(u[d]).reshape(n_c, nc).T
        mask[i, :u.shape[0]] = True
        sum_u[i, :u.shape[0]] = u.sum(axis=-1)
    Ufd2 = jnp.fft.rfft(jnp.asarray(Ud[..., ::-1], dtype), int(nfft2),
                        axis=-1)
    return dict(Ufd2=Ufd2, sum_u=jnp.asarray(sum_u, dtype),
                d_mask=jnp.asarray(mask), n=int(n), n_c=int(n_c),
                Dmax=int(Dmax), nc=int(nc), nfft2=int(nfft2), demux=True)


@partial(jax.jit, static_argnames=("n_c", "nc", "nfft2"))
def ds_bank_demux(x, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    """
    DS of one multiplexed chunk against a demuxed bank.
    x: [Lc] (Lc divisible by nc). Returns [S, Lc//nc - n_c + 1].
    """
    Lc = x.shape[0]
    L_c = Lc // nc
    n = n_c * nc
    mu = jnp.mean(x)
    sd = jnp.std(x)
    xs = (x - mu) / jnp.where(sd == 0, 1.0, sd)
    xc = xs.reshape(L_c, nc).T                       # [nc, L_c]

    # per-channel rolling sums -> multiplexed window stats at strided
    # starts (rolling.window_stats_rows)
    a, power = window_stats_rows(xc[None], n_c, n)
    a, power = a[0], power[0]

    xfd = jnp.fft.rfft(xc, nfft2, axis=-1)           # [nc, R2]
    # sum cross-spectra over channels, then ONE irfft per (S, D)
    spec = jnp.einsum("sdcr,cr->sdr", Ufd2, xfd,
                      precision=HIGHEST)             # [S, Dmax, R2]
    cc = jnp.fft.irfft(spec, nfft2, axis=-1)[:, :, n_c - 1:L_c]
    powsafe = jnp.where(power == 0, jnp.inf, power)
    y = cc - sum_u[:, :, None] * a[None, None, :]
    y = jnp.where(d_mask[:, :, None], y, 0.0)
    num = jnp.sum(y * y, axis=1)
    return num / powsafe[None, :]


@partial(jax.jit, static_argnames=("n_c", "nc", "nfft2"))
def ds_bank_demux_chunks(X, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    """Batch over chunks: X [B, Lc] -> [B, S, out]."""
    return jax.vmap(lambda x: ds_bank_demux(x, Ufd2, sum_u, d_mask, n_c, nc,
                                            nfft2))(X)


# ---------------------------------------------------------------------------
# Overlap-save demuxed formulation — the large-bank (matched-filter) path.
#
# A full-length cross-spectrum bank stores one rfft of size nfft2/2+1 per
# (template, channel): at 1000 templates x hour chunks that is ~6 GB of
# spectra and ~2 GB of per-chunk complex intermediates — HBM-prohibitive.
# Overlap-save correlation instead stores template spectra at a short block
# FFT (a few template lengths): the data channels are cut into overlapping
# blocks, transformed ONCE for all templates, conj-multiplied against the
# small spectra, and the circularly-contaminated head of each block's
# inverse transform is discarded. Identical math (up to f32 rounding),
# O(S * blk) memory instead of O(S * Lc).
# ---------------------------------------------------------------------------


def os_min_block(n_c):
    """Smallest legal overlap-save block FFT for per-channel template
    length n_c: the 128-aligned discard head plus one 128-sample output
    stride (see _os_geometry)."""
    pad0 = (-(n_c - 1)) % 128
    return n_c - 1 + pad0 + 128


def make_bank_demux_os(U_list, nc, blk_fft, dtype=jnp.float32, min_dmax=0):
    """Pack [D_i, n] multiplexed bases into an overlap-save demuxed bank:
    Ufd2 [S, Dmax, nc, blk_fft//2+1] (rfft of reversed per-channel
    templates at the block length)."""
    n = U_list[0].shape[1]
    assert n % nc == 0
    n_c = n // nc
    assert blk_fft >= os_min_block(n_c), \
        "block FFT too small: need >= aligned head + 128 " \
        "(os_min_block(n_c) = %d)" % os_min_block(n_c)
    S = len(U_list)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    Ud = np.zeros((S, Dmax, nc, n_c), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    sum_u = np.zeros((S, Dmax), dtype=np.float64)
    for i, u in enumerate(U_list):
        for d in range(u.shape[0]):
            Ud[i, d] = np.asarray(u[d]).reshape(n_c, nc).T
        mask[i, :u.shape[0]] = True
        sum_u[i, :u.shape[0]] = u.sum(axis=-1)
    Ufd2 = jnp.fft.rfft(jnp.asarray(Ud[..., ::-1], dtype), int(blk_fft),
                        axis=-1)
    return dict(Ufd2=Ufd2, sum_u=jnp.asarray(sum_u, dtype),
                d_mask=jnp.asarray(mask), n=int(n), n_c=int(n_c),
                Dmax=int(Dmax), nc=int(nc), blk_fft=int(blk_fft),
                demux=True, os=True)


@partial(jax.jit, static_argnames=("n_c", "nc", "blk_fft"))
def ds_bank_demux_os(x, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    """Overlap-save DS of one multiplexed chunk. Same contract as
    ds_bank_demux: x [Lc] -> [S, Lc//nc - n_c + 1]."""
    L_c = x.shape[0] // nc
    F, a, power = os_prep_batch(x[None], n_c, nc, blk_fft)
    ds = _os_ds(F, a, power, Ufd2, sum_u, d_mask, n_c, blk_fft, L_c)
    return ds[0, :, :L_c - n_c + 1]


def _os_geometry(L_c, n_c, blk_fft):
    """Overlap-save decomposition: left-pad the signal so each block's
    circularly-contaminated head D0 (>= n_c-1) is a multiple of 128; the
    block advance W = blk - D0 is then a multiple of 128 too, so the
    blocked output grid (m*W) tiles exactly into the trigger pyramid's
    128-sample blocks."""
    out_len = L_c - n_c + 1
    pad0 = (-(n_c - 1)) % 128
    D0 = n_c - 1 + pad0
    W = blk_fft - D0
    assert W >= 128, "block FFT too small for the aligned decomposition"
    m = -(-out_len // W)                        # block count
    return out_len, pad0, D0, W, m


# ---------------------------------------------------------------------------
# Overlap-save pipeline over a chunk batch.
#
# Every op takes the chunk batch as its leading dim, so a B-chunk batch is
# ONE instance of each op: one batched rolling-stats pass, one forward FFT
# over all (B, nc, m) frames, one inverse FFT over all (B, S, Dmax, m)
# blocks, one finalize. The fold-batch scan runs it on the whole batch; the
# per-chunk scan runs it at B=1 inside a lax.map. Folding costs memory: the
# inverse-transform output is [B, S, Dmax, m, blk] float32, which
# hbm_budget bounds (fold_scan_fits).
# ---------------------------------------------------------------------------


def os_prep_batch(X, n_c, nc, blk_fft):
    """Chunk-shared prep of the overlap-save pipeline — standardization,
    window stats, overlapping-window construction and the forward block
    transform: X [B, Lc] -> (F [B, nc, m, R], a [B, M], power [B, M]).
    Compute ONCE per chunk batch; every template block reuses it (XLA
    does not hoist this loop-invariant work out of a lax.map over template
    blocks)."""
    B, Lc = X.shape
    L_c = Lc // nc
    n = n_c * nc
    out_len, pad0, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    mu = jnp.mean(X, axis=1, keepdims=True)
    sd = jnp.std(X, axis=1, keepdims=True)
    xs = (X - mu) / jnp.where(sd == 0, 1.0, sd)
    xc = xs.reshape(B, L_c, nc).transpose(0, 2, 1)      # [B, nc, L_c]
    a, power = window_stats_rows(xc, n_c, n)            # [B, M]
    # overlapping data blocks: window i covers [i*W - pad0, i*W - pad0 +
    # blk) of the signal (the pad0 leading zeros shift output slot D0 of
    # block i to correlation position i*W); with stride W each window
    # spans at most ceil(blk/W)+1 consecutive W-rows of the padded
    # signal, so the frame matrix is a concat of shifted reshapes rather
    # than a gather
    k = -(-blk_fft // W) + 1
    xp = jnp.pad(xc, ((0, 0), (0, 0),
                      (pad0, (m + k - 1) * W - L_c - pad0)))
    rows = [xp[:, :, j * W:(m + j) * W].reshape(B, nc, m, W)
            for j in range(k)]
    xb = jnp.concatenate(rows, axis=3)[..., :blk_fft]   # [B, nc, m, blk]
    F = jnp.fft.rfft(xb, blk_fft, axis=-1)
    return F, a, power


def _os_ds(F, a, power, Ufd2, sum_u, d_mask, n_c, blk_fft, L_c):
    """DS of one template block from the shared prep: channel cross-
    spectra, block inverse FFTs, then drop each block's contaminated
    head, subtract the mean term, sum the squares over the basis and
    divide by the window power. Returns the UNMASKED full block-grid
    width [B, S, m*W]."""
    out_len, pad0, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    spec = jnp.einsum("sdcr,bcmr->bsdmr", Ufd2, F, precision=HIGHEST)
    cb = jnp.fft.irfft(spec, blk_fft, axis=-1)   # [B, S, Dmax, m, blk]
    powsafe = jnp.where(power == 0, jnp.inf, power)
    pad_w = m * W - out_len
    ap = jnp.pad(a, ((0, 0), (0, pad_w)))
    pp = jnp.pad(powsafe, ((0, 0), (0, pad_w)), constant_values=1.0)
    B, S, Dmax = cb.shape[:3]
    cc = cb[..., D0:D0 + W].reshape(B, S, Dmax, m * W)
    y = cc - sum_u[None, :, :, None] * ap[:, None, None, :]
    y = jnp.where(d_mask[None, :, :, None], y, 0.0)
    return jnp.sum(y * y, axis=2) / pp[:, None, :]


def _mask_pyramid(ds, nv):
    """Mask DS positions >= nv (pad windows) to -inf and take the
    per-128-sample block maxima the trigger pyramid starts from.
    ds [..., L] with L a multiple of 128; nv broadcasts against
    ds[..., :1]."""
    pos = jnp.arange(ds.shape[-1])
    ds = jnp.where(pos < nv, ds, -jnp.inf)
    pyr = ds.reshape(ds.shape[:-1] + (-1, 128)).max(axis=-1)
    return ds, pyr


def os_block_scan_batch(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft,
                        L_c, nv):
    """Scan-path compute of one template block from the shared prep:
    F [B, nc, m, R], a/power [B, M], nv [B] -> (ds [B, S, m*W] masked to
    -inf past nv, pyr [B, S, (m*W)//128] per-128-sample block maxima)."""
    ds = _os_ds(F, a, power, Ufd2, sum_u, d_mask, n_c, blk_fft, L_c)
    return _mask_pyramid(ds, jnp.asarray(nv, jnp.int32)[:, None, None])


def fold_scan_fits(B, S, Dmax, n_c, blk_fft, L_c):
    """True when the fold-batch scan's [B, S, Dmax, m, blk] float32
    inverse-transform intermediate fits hbm_budget()."""
    _, _, _, _, m = _os_geometry(L_c, n_c, blk_fft)
    return B * S * Dmax * m * blk_fft * 4 <= hbm_budget()


# full-length spectra above this many complex elements switch the bank to
# the overlap-save form (S * Dmax * nc * (nfft2/2+1))
OS_SPECTRA_BUDGET = 1 << 26


def pad_rows(S):
    """Detector-row count ladder for shape-canonical banks: the smallest
    S' >= S that is a multiple of max(8, 2^(bit_length(S-1)-3)) — i.e.
    multiples of 8 up to 64, then ~12.5%-granularity rungs (96, 112, 128,
    160, ...). Detector banks padded to a rung share one compiled XLA
    program across stations/groups whose true counts land on the same
    rung, instead of one program per exact count (each program costs a
    fresh XLA compile — SURVEY §7 "keep XLA compile counts bounded");
    the pad rows are all-zero templates whose DS is identically 0.
    Wasted compute is bounded at ~12.5%.
    DETEX_TPU_PAD_BANKS=0 disables both shape ladders (exact counts)."""
    S = int(S)
    if os.environ.get("DETEX_TPU_PAD_BANKS", "1") == "0":
        return S
    if S <= 8:
        return 8
    q = max(8, 1 << (int(S - 1).bit_length() - 3))
    return -(-S // q) * q


def pad_dims(D):
    """Basis-dimension ladder (next power of two): banks whose true Dmax
    lands on the same rung share a compiled program; masked pad slots are
    zero templates. DETEX_TPU_PAD_BANKS=0 disables."""
    if os.environ.get("DETEX_TPU_PAD_BANKS", "1") == "0":
        return int(D)
    return 1 << max(int(D - 1).bit_length(), 0)


def build_bank(U_list, nc, data_len_samps, dtype=jnp.float32,
               block_fft=None, prefer_os=False, pad_S=None, min_dmax=0):
    """
    Pack basis arrays into the fastest applicable bank for scanning chunks
    of ``data_len_samps`` multiplexed samples: the demultiplexed (polyphase)
    form when the template length divides into the channels, else the
    multiplexed form. Also records ``pad_len`` (fixed chunk padding) and the
    FFT length.

    Large banks (many matched-filter templates) automatically use the
    overlap-save demuxed form, which stores template spectra at a short
    block FFT instead of the full chunk length (``block_fft`` forces a
    specific block size; block_fft=0 forces full-length).
    ``prefer_os=True`` chooses the overlap-save form for SMALL banks too.

    ``pad_S`` pads the detector-row count with all-zero templates (DS
    identically 0) and ``min_dmax`` pads the basis-slot count with masked
    zero slots: banks padded to a shared shape ladder (:func:`pad_rows`,
    :func:`pad_dims`) compile ONE program per rung instead of one per
    exact count. Callers that index detector rows must use their true row
    list (e.g. bank["names"]), not ``sum_u``'s padded leading dim.
    """
    n = U_list[0].shape[1]
    if pad_S is not None and int(pad_S) > len(U_list):
        U_list = list(U_list) + [np.zeros((1, n), np.float64)] * (
            int(pad_S) - len(U_list))
    pad_len = int(data_len_samps)
    pad_len += (-pad_len) % nc  # keep divisible by nc
    if n % nc == 0:
        n_c = n // nc
        L_c = pad_len // nc
        nfft2 = 2 ** int(L_c + n_c).bit_length()
        Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
        full_elems = len(U_list) * Dmax * nc * (nfft2 // 2 + 1)
        use_os = (block_fft if block_fft is not None
                  else (prefer_os or full_elems > OS_SPECTRA_BUDGET))
        if use_os:
            blk = int(block_fft) if block_fft else \
                2 ** int(4 * n_c).bit_length()
            # the aligned decomposition needs head + one 128-stride
            # (short templates would otherwise get an all-head block)
            while blk < os_min_block(n_c):
                blk *= 2
            blk = min(blk, nfft2)
            if blk < os_min_block(n_c):  # chunk too short for OS blocks
                bank = make_bank_demux(U_list, nc, nfft2, dtype,
                                       min_dmax=min_dmax)
            else:
                bank = make_bank_demux_os(U_list, nc, blk, dtype,
                                          min_dmax=min_dmax)
        else:
            bank = make_bank_demux(U_list, nc, nfft2, dtype,
                                   min_dmax=min_dmax)
    else:
        nfft = 2 ** int(pad_len + n).bit_length()
        bank = make_bank(U_list, nfft, dtype, min_dmax=min_dmax)
        bank["nfft"] = nfft
        bank["demux"] = False
        bank["nc"] = int(nc)
    bank["pad_len"] = pad_len
    return bank


def run_bank(x_np, bank, nc, nfft=None, pad_len=None):
    """
    Run a detector bank over one (possibly ragged) host chunk with
    fixed-shape padding so XLA compiles once per (pad_len, bank) shape.

    Returns a numpy [S, n_valid] DS array where n_valid covers only windows
    fully inside the real data (pad windows are sliced off; DS is invariant
    to the affine standardization including pad zeros for those windows).

    NOTE: this transfers the WHOLE [S, n_valid] array device->host. When
    only a few detector rows are needed (the engine's triggered-chunk
    re-verify), use :func:`run_bank_rows` — one bank compute, row-sized
    transfers.
    """
    x_np = np.asarray(x_np)
    Lc = len(x_np)
    n = bank["n"]
    if pad_len is None:
        pad_len = bank.get("pad_len", Lc + ((-Lc) % nc))
    if Lc > pad_len:
        x_np = x_np[:pad_len]
        Lc = pad_len
    xp = np.zeros(pad_len, dtype=np.float32)
    xp[:Lc] = x_np
    if bank.get("os"):
        out = ds_bank_demux_os(jnp.asarray(xp), bank["Ufd2"], bank["sum_u"],
                               bank["d_mask"], bank["n_c"], int(nc),
                               bank["blk_fft"])
    elif bank.get("demux"):
        out = ds_bank_demux(jnp.asarray(xp), bank["Ufd2"], bank["sum_u"],
                            bank["d_mask"], bank["n_c"], int(nc),
                            bank["nfft2"])
    else:
        if nfft is None:
            nfft = bank["nfft"]
        out = ds_bank(jnp.asarray(xp), bank["Ufd"], bank["sum_u"],
                      bank["d_mask"], bank["n"], int(nc), int(nfft))
    n_valid = (Lc - n) // int(nc) + 1
    if n_valid <= 0:
        return np.zeros((out.shape[0], 0), dtype=np.float32)
    return np.asarray(out[:, :n_valid])


def run_bank_rows(x_np, bank, nc, rows):
    """
    DS of selected detector rows over one host chunk: ONE bank compute on
    device, then only ``rows`` (an iterable of row indices) cross back to
    host. This is the triggered-chunk re-verify path of the detection
    engine: a chunk where k of S detectors trigger costs one bank launch
    plus k row-sized transfers instead of k full-bank launches each
    copying the whole [S, L] DS array device->host.

    Returns a dict {row_index: numpy [n_valid] DS vector}.
    """
    rows = list(rows)
    if not rows:
        return {}
    x_np = np.asarray(x_np)
    Lc = len(x_np)
    n = bank["n"]
    pad_len = bank.get("pad_len", Lc + ((-Lc) % nc))
    if Lc > pad_len:
        x_np = x_np[:pad_len]
        Lc = pad_len
    xp = np.zeros(pad_len, dtype=np.float32)
    xp[:Lc] = x_np
    if bank.get("os"):
        out = ds_bank_demux_os(jnp.asarray(xp), bank["Ufd2"], bank["sum_u"],
                               bank["d_mask"], bank["n_c"], int(nc),
                               bank["blk_fft"])
    elif bank.get("demux"):
        out = ds_bank_demux(jnp.asarray(xp), bank["Ufd2"], bank["sum_u"],
                            bank["d_mask"], bank["n_c"], int(nc),
                            bank["nfft2"])
    else:
        out = ds_bank(jnp.asarray(xp), bank["Ufd"], bank["sum_u"],
                      bank["d_mask"], bank["n"], int(nc), bank["nfft"])
    n_valid = (Lc - n) // int(nc) + 1
    if n_valid <= 0:
        z = np.zeros(0, dtype=np.float32)
        return {int(si): z for si in rows}
    # basic (non-advanced) indexing per row: each pull is a tiny sliced
    # program over the SAME bank result — no per-count recompiles, and
    # only len(rows) * n_valid floats are copied to host
    return {int(si): np.asarray(out[int(si), :n_valid]) for si in rows}


def _bank_batch_out(x_list, bank, nc):
    """Shared batched bank program: pad the host chunks to a power-of-two
    batch (shared compile classes), run the whole bank in ONE device
    program (fold-batch when it fits, else lax.map) and return the
    DEVICE [Bp, S, L] DS array plus the per-chunk valid lengths — the
    caller decides what (rows, trigger windows, ...) is copied to host."""
    pad_len = bank["pad_len"]
    B = len(x_list)
    Bp = 1 << (B - 1).bit_length()        # power-of-two compile classes
    X = np.zeros((Bp, pad_len), np.float32)
    lens = []
    for i, x in enumerate(x_list):
        L = min(len(x), pad_len)
        X[i, :L] = np.asarray(x[:L], np.float32)
        lens.append(L)
    lens.extend([0] * (Bp - B))
    return _bank_batch_program(jnp.asarray(X), lens, bank, nc)


def _bank_batch_program(Xd, lens, bank, nc):
    """Program part of :func:`_bank_batch_out` on an already-device-
    resident, already-padded [Bp, pad_len] chunk batch (``lens`` zero-
    padded to Bp; zero-length slots are fully masked by nv). The
    engine's device-windowed re-verify feeds this directly so triggered
    chunks — uploaded once for the scan — are never re-uploaded."""
    n = bank["n"]
    pad_len = bank["pad_len"]
    assert Xd.shape == (len(lens), pad_len)
    if bank.get("os"):
        if fold_scan_fits(Xd.shape[0], int(bank["sum_u"].shape[0]),
                          int(bank["Dmax"]), bank["n_c"], bank["blk_fft"],
                          pad_len // int(nc)):
            nv = jnp.asarray([max((L - n) // int(nc) + 1, 0) for L in lens],
                             jnp.int32)
            out = _run_bank_batch_fold(Xd, nv, bank["Ufd2"],
                                       bank["sum_u"], bank["d_mask"],
                                       bank["n_c"], int(nc),
                                       bank["blk_fft"])
        else:
            out = _ds_map_demux_os(Xd, bank["Ufd2"], bank["sum_u"],
                                   bank["d_mask"], bank["n_c"], int(nc),
                                   bank["blk_fft"])
    elif bank.get("demux"):
        out = _ds_map_demux(Xd, bank["Ufd2"], bank["sum_u"],
                            bank["d_mask"], bank["n_c"], int(nc),
                            bank["nfft2"])
    else:
        out = _ds_map_mux(Xd, bank["Ufd"], bank["sum_u"], bank["d_mask"],
                          bank["n"], int(nc), bank["nfft"])
    return out, lens


def run_bank_triggers_batch(x_list, bank, nc, rows_list, thr_list, sr_list,
                            lta_time, sta_time, use_stalta,
                            max_triggers=4096, x_dev=None, lens_dev=None):
    """
    Device-windowed dense re-verify (the engine's triggered-chunk path):
    the bank DS rows, the optional DS STA/LTA and the exact trigger
    extraction all run inside the batched device program; only the
    per-trigger indices and values are copied to host (~KBs vs ~12 MB of
    full-row round trips per triggered detector — the host chain
    downloads the row, re-uploads it for the STA/LTA kernel, downloads
    that, and uploads the row again for extract_triggers).

    The on-device chain (ops/triggers.trigger_rows_device) replicates
    the host order exactly — inf-zeroing when max > 1.1, centered
    STA/LTA, while-loop argmax/suppression extraction — on the very same
    f32 rows the host path would transfer, so results are bit-identical
    (tests/test_device_triggers.py asserts it end to end).

    Parameters mirror run_bank_rows_batch plus: ``thr_list`` — per chunk,
    an iterable of per-row trigger thresholds aligned with that chunk's
    ``rows_list`` entry; ``sr_list`` — per-chunk sampling rates (the
    20 s suppression buffer and STA/LTA windows are sample counts);
    ``lta_time``/``sta_time`` in seconds; ``use_stalta`` computes the
    STA/LTA values (engine: not fillZeros and triggerLTATime).

    Returns a list of dicts, one per chunk:
    {row_index: (idx int64[count], ds_at float32[count],
                 stalta_at float32[count] | None)}.

    ``x_dev``/``lens_dev``: optional DEVICE-resident alternative to
    ``x_list`` — a [Nsel, pad_len] float32 array of the triggered chunks
    (already padded to the bank's pad_len, e.g. gathered from the batch
    the scan uploaded) plus their valid lengths. Avoids re-uploading
    megabytes of chunk data the device already holds; ``x_list`` is then
    only consulted for its length (it may be the host payloads kept for
    the magnitude windows).
    """
    if not x_list and x_dev is None:
        return []
    from detex_tpu.ops import triggers as _trig
    if x_dev is not None:
        Nsel = x_dev.shape[0]
        Bp = 1 << max(Nsel - 1, 0).bit_length()
        # pad to a power of two via a row gather (index 0 repeated) with
        # the pad slots' lens zeroed -> fully nv-masked downstream
        sel = list(range(Nsel)) + [0] * (Bp - Nsel)
        Xd = jnp.take(x_dev, jnp.asarray(sel, jnp.int32), axis=0)
        lens = list(lens_dev) + [0] * (Bp - Nsel)
        out, lens = _bank_batch_program(Xd, lens, bank, nc)
        n_chunks = Nsel
    else:
        out, lens = _bank_batch_out(x_list, bank, nc)
        n_chunks = len(x_list)
    n = bank["n"]
    res = [dict() for _ in range(n_chunks)]
    # group jobs by the static parameters so each group is ONE jitted
    # program (rows padded to a power of two for shared compile classes)
    groups = {}
    for ci, (rows, thrs, sr) in enumerate(zip(rows_list, thr_list,
                                              sr_list)):
        L = (lens[ci] - n) // int(nc) + 1
        if L <= 0:
            z = np.zeros(0, np.float32)
            for si in rows:
                res[ci][int(si)] = (np.zeros(0, np.int64), z,
                                    z if use_stalta else None)
            continue
        buff = int(20 * sr)              # reference buff=20 s
        # replicate ds_stalta's window clamps exactly
        sta_n = max(int(sta_time * sr), 0) if use_stalta else 1
        sta_n = sta_n or 1
        lta_n = max(int(lta_time * sr), 1) if use_stalta else 1
        key = (L, sta_n, lta_n, buff)
        for si, thr in zip(rows, thrs):
            groups.setdefault(key, []).append((ci, int(si), float(thr)))
    for (L, sta_n, lta_n, buff), jobs in groups.items():
        R = len(jobs)
        Rp = 1 << (R - 1).bit_length()
        jp = jobs + [jobs[0]] * (Rp - R)
        cis = jnp.asarray([j[0] for j in jp], jnp.int32)
        sis = jnp.asarray([j[1] for j in jp], jnp.int32)
        thr = jnp.asarray([j[2] for j in jp], jnp.float32)
        rows_dev = out[cis, sis]                       # [Rp, Lv] gather
        idx_d, cnt_d, dsv_d, slv_d = _trig.trigger_rows_device(
            rows_dev, thr, L, sta_n, lta_n, buff, max_triggers,
            use_stalta)
        # ONE blocking transfer for the whole group: counts + the first
        # CAP trigger columns of idx/ds/stalta packed into a single f32
        # array (idx and cnt are < 2^24, exact in f32) instead of a
        # count-then-slice flow of TWO dependent round trips plus one per
        # output array; the escalation re-fetch below only fires when
        # some row exceeds CAP triggers.
        cap = min(64, int(max_triggers))
        if L >= (1 << 24):
            cap = 0          # idx would lose f32 exactness; unpacked path
        if cap:
            packed = np.asarray(_trig.pack_trigger_outputs(
                idx_d, cnt_d, dsv_d, slv_d if use_stalta else None, cap))
            cnt = packed[:, 0].astype(np.int64)
            idx = packed[:, 1:1 + cap].astype(np.int64)
            dsv = packed[:, 1 + cap:1 + 2 * cap].astype(np.float32)
            slv = packed[:, 1 + 2 * cap:] if use_stalta else None
            cmax = max(int(cnt.max()), 1)
        else:
            cnt = np.asarray(cnt_d).astype(np.int64)
            cmax = max(int(cnt.max()), 1)
        if cmax > cap:
            # rare: more than CAP triggers on some row — re-fetch full
            # columns (power-of-two sliced so shapes share compiles)
            cp = 1 << (cmax - 1).bit_length()
            idx = np.asarray(idx_d[:, :cp]).astype(np.int64)
            dsv = np.asarray(dsv_d[:, :cp])
            slv = np.asarray(slv_d[:, :cp]) if use_stalta else None
        for k, (ci, si, _t) in enumerate(jobs):
            nf = int(cnt[k])
            res[ci][si] = (idx[k, :nf], dsv[k, :nf],
                           np.asarray(slv[k, :nf], np.float32)
                           if use_stalta else None)
    return res


def run_bank_rows_batch(x_list, bank, nc, rows_list):
    """
    Batched :func:`run_bank_rows`: ``x_list`` is a list of host chunks and
    ``rows_list`` the matching list of row-index iterables. ALL chunks run
    in ONE device program (the fold-batch scan when it fits, else a
    lax.map — same kernels as run_bank_batch), padded to the next
    power-of-two batch so distinct trigger counts share compiles; only the
    requested rows are copied back to host.

    This is the dense-detection re-verify path: a batch where k chunks
    trigger costs one k'-padded bank launch instead of k single-chunk
    launches, each paying the full per-op dispatch cost.

    Returns a list of {row_index: numpy [n_valid_i]} dicts, one per chunk.
    """
    if not x_list:
        return []
    if len(x_list) == 1:
        return [run_bank_rows(x_list[0], bank, nc, rows_list[0])]
    out, lens = _bank_batch_out(x_list, bank, nc)
    n = bank["n"]
    B = len(x_list)
    res = []
    for i in range(B):
        n_valid = (lens[i] - n) // int(nc) + 1
        if n_valid <= 0:
            z = np.zeros(0, dtype=np.float32)
            res.append({int(si): z for si in rows_list[i]})
            continue
        res.append({int(si): np.asarray(out[i, int(si), :n_valid])
                    for si in rows_list[i]})
    return res


def run_bank_batch(x_list, bank, nc):
    """
    Run a detector bank over a list of host chunks in ONE device call
    (the fold-batch scan when it fits, else lax.map over the stacked
    batch — _bank_batch_out, which also pads the batch to the next power
    of two so ragged trailing batches share compile classes instead of
    each compiling a fresh program). Returns a list of numpy
    [S, n_valid_i] DS arrays, one per input chunk.
    """
    if not x_list:
        return []
    out, lens = _bank_batch_out(x_list, bank, nc)
    n = bank["n"]
    out = np.asarray(out)
    res = []
    for i in range(len(x_list)):
        n_valid = (lens[i] - n) // int(nc) + 1
        res.append(out[i, :, :max(n_valid, 0)])
    return res


@partial(jax.jit, static_argnames=("n_c", "nc", "blk_fft"))
def _run_bank_batch_fold(X, nv, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    F, a, power = os_prep_batch(X, n_c, nc, blk_fft)
    ds, _ = os_block_scan_batch(F, a, power, Ufd2, sum_u, d_mask, n_c,
                                nc, blk_fft, X.shape[1] // nc, nv)
    return ds                      # [B, S, m*W]; caller slices n_valid


@partial(jax.jit, static_argnames=("n_c", "nc", "nfft2"))
def _ds_map_demux(X, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    return jax.lax.map(lambda x: ds_bank_demux(x, Ufd2, sum_u, d_mask,
                                               n_c, nc, nfft2), X)


@partial(jax.jit, static_argnames=("n_c", "nc", "blk_fft"))
def _ds_map_demux_os(X, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    return jax.lax.map(lambda x: ds_bank_demux_os(x, Ufd2, sum_u, d_mask,
                                                  n_c, nc, blk_fft), X)


@partial(jax.jit, static_argnames=("n", "nc", "nfft"))
def _ds_map_mux(X, Ufd, sum_u, d_mask, n, nc, nfft):
    return jax.lax.map(lambda x: ds_bank(x, Ufd, sum_u, d_mask, n, nc,
                                         nfft), X)


# ---------------------------------------------------------------------------
# Host-side numpy oracle (used by tests and as a CPU fallback). This is the
# straightforward transliteration of the math above in float64.
# ---------------------------------------------------------------------------


def ds_numpy(x, U, nc):
    """float64 reference implementation of the DS statistic."""
    x = np.asarray(x, np.float64)
    U = np.asarray(U, np.float64)
    D, n = U.shape
    Lc = len(x)
    # nfft >= Lc keeps the sliced region [n-1:Lc] free of circular wrap
    nfft = 2 ** int(Lc).bit_length()
    c = np.cumsum(np.insert(x, 0, 0.0))
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    rsum = c[n:] - c[:-n]
    rsum2 = c2[n:] - c2[:-n]
    a = rsum / n
    var_samp = (rsum2 - rsum * rsum / n) / (n - 1)
    power = var_samp * n
    xfd = np.fft.rfft(x, nfft)
    Ufd = np.fft.rfft(U[:, ::-1], nfft, axis=-1)
    cc = np.fft.irfft(Ufd * xfd[None, :], nfft, axis=-1)[:, n - 1:Lc]
    y = cc - U.sum(axis=1)[:, None] * a[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ds = (y ** 2).sum(axis=0) / power
    return ds[::nc]
