"""
On-device chunk preprocessing fused into the DS scan.

The reference preprocesses every continuous chunk on host (obspy bandpass +
detrend + multiplex, construct.py:990-1030) before the detection statistic.
Host prep can cost far more than the device scan of the same chunk, so
detex_tpu can instead do it on device, inside the FFTs the scan already
performs:

  - linear detrend: closed-form masked least squares per channel
  - zero-phase Butterworth bandpass: multiply the channel spectra by
    |H(e^jw)|^2 (the exact amplitude response of obspy's forward+reverse
    SOS pass); the only difference from the host path is circular (vs
    linear) edge transients, which die inside the chunk overlap buffer
  - standardization for f32 accuracy is applied algebraically to the
    spectra (the DS is affine-invariant), so only 3 extra irFFTs are paid

Enabled with ``SubSpace.detex(devicePrep=True)``. Decimation is supported
on device too: with ``dec > 1`` the channel spectra are truncated at the
decimated Nyquist (an ideal anti-alias lowpass + spectral resample), valid
whenever the bandpass keeps energy below the decimated Nyquist — the
detection engine checks this and falls back to host prep otherwise.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _sig


def butter_response(filt, sr, nfft, zerophase=True):
    """
    Complex frequency response (length nfft//2+1) of the obspy-style
    Butterworth bandpass at the rfft bins of ``nfft``; zerophase squares
    the magnitude and cancels the phase (|H|^2), matching a forward+reverse
    pass.
    """
    freqmin, freqmax, corners = filt[0], filt[1], int(filt[2])
    nyq = 0.5 * sr
    low = freqmin / nyq
    high = min(freqmax / nyq, 1.0 - 1e-6)
    sos = _sig.iirfilter(corners, [low, high], btype="band", ftype="butter",
                         output="sos")
    w, h = _sig.sosfreqz(sos, worN=nfft // 2 + 1, whole=False)
    if zerophase:
        h = (h * np.conj(h)).real.astype(np.float32)  # |H|^2, zero phase
        return jnp.asarray(h, jnp.float32)
    return jnp.asarray(h.astype(np.complex64))


def _masked_detrend(xc, Lv):
    """Per-channel linear detrend fit on the first Lv samples (the valid
    region of a zero-padded channel), applied everywhere."""
    nc, L = xc.shape
    i = jnp.arange(L, dtype=jnp.float32)
    w = (i < Lv).astype(jnp.float32)
    nn = jnp.sum(w)
    st = jnp.sum(w * i)
    stt = jnp.sum(w * i * i)
    sy = jnp.sum(xc * w[None, :], axis=1)
    sty = jnp.sum(xc * (w * i)[None, :], axis=1)
    det = nn * stt - st * st
    det = jnp.where(det == 0, 1.0, det)   # empty/degenerate pad chunks
    nn = jnp.maximum(nn, 1.0)
    b = (nn * sty - st * sy) / det
    a = (sy - b * st) / nn
    fit = a[:, None] + b[:, None] * i[None, :]
    return (xc - fit) * w[None, :]


@partial(jax.jit, static_argnames=("n_c", "nc", "nfft2", "dec"))
def ds_bank_demux_raw(xc, Lv, H, Ufd2, sum_u, d_mask, n_c, nc, nfft2,
                      dec=1):
    """
    DS of one chunk from RAW per-channel data with fused preprocessing.

    xc: [nc, L_raw] raw channels zero-padded to ``dec x`` the bank's
    per-channel pad length; Lv: scalar true per-channel RAW sample count;
    H: rfft-bin filter response at the raw rate over dec*nfft2 bins (real
    for zerophase); bank arrays as in ds_bank_demux. ``dec`` > 1 resamples
    on device by spectral truncation (ideal anti-alias lowpass) — valid
    when the bandpass keeps energy below the decimated Nyquist.
    Returns [S, L_c - n_c + 1] at the decimated rate (caller masks windows
    beyond Lv // dec).
    """
    L_c = xc.shape[1] // dec
    n = n_c * nc
    xd = _masked_detrend(xc, Lv)
    F = jnp.fft.rfft(xd, dec * nfft2, axis=-1)        # [nc, dec*R2..]
    Ff = F * H[None, :]
    if dec > 1:
        Ff = Ff[:, : nfft2 // 2 + 1]                  # spectral resample
        Lv = Lv // dec
    xf = jnp.fft.irfft(Ff, nfft2, axis=-1)[:, :L_c]   # filtered channels
    # standardization statistics over the valid region only
    i = jnp.arange(L_c)
    w = (i < Lv).astype(xf.dtype)[None, :]
    cnt = jnp.sum(w) * nc
    mu = jnp.sum(xf * w) / cnt
    var = jnp.sum((xf - mu) ** 2 * w) / cnt
    sd = jnp.sqrt(jnp.maximum(var, 1e-30))
    xs = ((xf - mu) / sd) * w                         # standardized, pad=0

    from detex_tpu.ops.rolling import window_stats_rows
    a, power = window_stats_rows(xs[None], n_c, n)
    a, power = a[0], power[0]

    # correlation spectra from the UNstandardized filtered spectra, fixed
    # up algebraically: cc_std = (cc_raw - mu * sum_u) / sd
    spec = jnp.einsum("sdcr,cr->sdr", Ufd2, Ff,
                      precision=jax.lax.Precision.HIGHEST)  # [S, Dmax, R2]
    cc = jnp.fft.irfft(spec, nfft2, axis=-1)[:, :, n_c - 1:L_c]
    su = jnp.where(d_mask, sum_u, 0.0)
    cc = (cc - mu * su[:, :, None]) / sd
    powsafe = jnp.where(power == 0, jnp.inf, power)
    y = cc - su[:, :, None] * a[None, None, :]
    num = jnp.sum(y * y, axis=1)
    return num / powsafe[None, :]


@partial(jax.jit, static_argnames=("nfftp", "dec", "nc"))
def prep_multiplex_batch(Xc, LV, H, nfftp, dec, nc):
    """
    Batched device preprocessing producing MULTIPLEXED chunks for the
    overlap-save scan routes: the devicePrep engine's monolithic
    per-chunk kernel (ds_bank_demux_raw) needs full-length spectra and
    therefore cannot serve overlap-save banks; splitting prep from scan
    lets devicePrep runs use them.

    Xc : [B, nc, L_raw] raw channels (zero-padded rows)
    LV : [B] int32 true per-channel RAW sample counts
    H  : rfft response over dec*nfftp bins (real = zerophase |H|^2),
         same butter_response contract as ds_bank_demux_raw
    nfftp : per-channel FFT length at the DECIMATED rate (>= L_c + n_c,
         the same formula the demux banks use, so H is bit-identical to
         the monolithic path's)
    dec : on-device decimation by spectral truncation

    Returns (X [B, L_c*nc] multiplexed filtered channels with pad
    samples zeroed, lens [B] valid MULTIPLEXED sample counts). The fold
    scan re-standardizes each chunk (the DS is affine-invariant), so no
    standardization happens here.
    """
    B, nch, L_raw = Xc.shape
    L_c = L_raw // dec
    xd = jax.vmap(_masked_detrend)(Xc, LV)
    F = jnp.fft.rfft(xd, dec * nfftp, axis=-1)
    Ff = F * H[None, None, :]
    if dec > 1:
        Ff = Ff[:, :, : nfftp // 2 + 1]
    LVd = LV // dec
    xf = jnp.fft.irfft(Ff, nfftp, axis=-1)[:, :, :L_c]
    # zero the pad region: filter ringing past the valid samples would
    # otherwise leak into the (masked) pad windows' rolling stats
    i = jnp.arange(L_c)
    w = (i[None, :] < LVd[:, None]).astype(xf.dtype)
    xf = xf * w[:, None, :]
    X = jnp.swapaxes(xf, 1, 2).reshape(B, L_c * nch)   # multiplex
    return X, LVd * nch


def run_bank_raw(chans, bank, nc, H, dec=1):
    """
    Host wrapper: raw channel stack [nc, L_raw] -> DS [S, n_valid] through
    the fused device prep + scan (counterpart of ds.run_bank for the
    devicePrep path). ``dec`` decimates on device (bank built at the
    decimated rate).
    """
    chans = np.asarray(chans, np.float32)
    L = chans.shape[1]
    L_pad = (bank["pad_len"] // nc) * dec
    if L > L_pad:
        chans = chans[:, :L_pad]
        L = L_pad
    xp = np.zeros((nc, L_pad), np.float32)
    xp[:, :L] = chans
    out = ds_bank_demux_raw(jnp.asarray(xp), jnp.int32(L),
                            H, bank["Ufd2"], bank["sum_u"], bank["d_mask"],
                            bank["n_c"], int(nc), bank["nfft2"], int(dec))
    n_valid = ((L // dec) * nc - bank["n"]) // nc + 1
    if n_valid <= 0:
        return np.zeros((out.shape[0], 0), np.float32)
    return np.asarray(out[:, :n_valid])
