"""
Sharded continuous-data scan: the multi-device performance path.

Chunks of multiplexed continuous data are sharded across the mesh's
``chunks`` axis with ``shard_map``; each device runs the DS bank over its
chunks, bins its DS values, and extracts fixed-capacity trigger lists. Only
a ``psum`` of the histograms crosses devices; trigger lists stay
chunk-sharded and are gathered by the host at the end (SURVEY.md section 2:
the DS computation itself needs no cross-device communication).
"""
from __future__ import annotations

import os
from collections import Counter
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from detex_tpu.ops import ds as _ds
from detex_tpu.ops import triggers as _triggers

DEFAULT_BINS = np.linspace(0, 1, 401)

# ---------------------------------------------------------------------------
# Kernel-route observability: every scan entry point records which route it
# dispatched (fold / blocked-fold / plain, plus sharded/devicePrep markers)
# in this public counter and logs each NEW route once. Tests and
# __graft_entry__ read the counter.
# ---------------------------------------------------------------------------
ROUTE_COUNTS = Counter()
_ROUTES_LOGGED = set()

#: route -> name recorded in ROUTE_COUNTS (see _os_fold_route)
ROUTE_NAMES = {"fold": "fold", "blocked": "blocked-fold", None: "plain"}


def _note_route(name, sharded=False, device_prep=False):
    """Count + log (once per unique route string) the kernel route an
    engine scan dispatched."""
    if sharded:
        name += "+sharded"
    if device_prep:
        name += "+devicePrep"
    ROUTE_COUNTS[name] += 1
    if name not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add(name)
        import detex_tpu
        detex_tpu.log(__name__, "scan kernel route: %s" % name, pri=True)
    return name


def engine_mesh():
    """
    The mesh the production detection engine shards its chunk batches over:
    a 1-D mesh across all local devices when more than one is present
    (disable with ``DETEX_TPU_MESH=0``), else None (single-device path).
    """
    if os.environ.get("DETEX_TPU_MESH", "1") == "0":
        return None
    devs = jax.devices()
    if len(devs) < 2:
        return None
    from detex_tpu.parallel.mesh import make_mesh
    return make_mesh()


def _pad_batch(n_dev, X, nv):
    """Round the chunk batch up to a multiple of the mesh size with
    zero-length (fully masked) chunks; returns (Xp, nvp, B_orig)."""
    B = X.shape[0]
    Bp = -(-B // n_dev) * n_dev
    if Bp == B:
        return X, nv, B
    Xp = np.zeros((Bp,) + X.shape[1:], X.dtype)
    Xp[:B] = X
    nvp = np.zeros(Bp, nv.dtype)
    nvp[:B] = nv
    return Xp, nvp, B


def _require_host_array(X, fn_name):
    """Refuse device-resident chunk batches on the sharded entry points:
    they are padded/resharded on host here, and a device array would be
    silently copied device->host first — the same contract scan_chunks
    documents for the single-device path."""
    if isinstance(X, jax.Array) and not isinstance(X, np.ndarray):
        if any(d.platform != "cpu" for d in X.devices()):
            raise TypeError(
                "%s requires host (numpy) chunk arrays: a device-resident "
                "batch would be copied device->host here. Pass the numpy "
                "source array instead." % fn_name)


def _hist_counts(ds, bins):
    """np.histogram-compatible device binning via sort + edge search
    (values outside [bins[0], bins[-1]], including the -inf pad mask, fall
    outside every bin)."""
    s = jnp.sort(ds)
    lo = jnp.searchsorted(s, bins[:-1], side="left")
    hi_last = jnp.searchsorted(s, bins[-1], side="right")
    pos = jnp.concatenate([lo, hi_last[None]])
    return jnp.diff(pos).astype(jnp.int32)


def _hist_rows(ds, bins, calc_hist):
    """Per-row histogram of ds [s, L] -> [s, nbins] int32 (zeros when
    ``calc_hist`` is off)."""
    if not calc_hist:
        return jnp.zeros((ds.shape[0], bins.shape[0] - 1), jnp.int32)
    return jax.vmap(lambda v: _hist_counts(v, bins))(ds)


def _bank_arrays(bank):
    """The device arrays of a bank (leading pytree args for jit), with the
    template axis pre-blocked (host-side, cached on the bank dict) when the
    bank exceeds TEMPLATE_BLOCK detectors — in-jit padding would copy the
    whole spectra bank per chunk call."""
    raw = (bank["Ufd2"], bank["sum_u"], bank["d_mask"]) \
        if bank.get("demux") else \
        (bank["Ufd"], bank["sum_u"], bank["d_mask"])
    S = raw[0].shape[0]
    if S <= TEMPLATE_BLOCK:
        return raw
    if "_blocked_arrs" not in bank:
        SB = TEMPLATE_BLOCK
        Sp = -(-S // SB) * SB
        bank["_blocked_arrs"] = tuple(
            jnp.pad(a, [(0, Sp - S)] + [(0, 0)] * (a.ndim - 1))
            .reshape((Sp // SB, SB) + a.shape[1:]) for a in raw)
    return bank["_blocked_arrs"]


def _blocked_thresholds(bank, thresholds):
    """Thresholds shaped to match _bank_arrays' blocking ([nB, SB] with the
    pad slots at +inf, or flat [S])."""
    thresholds = np.asarray(thresholds, np.float32)
    S = len(thresholds)
    if S <= TEMPLATE_BLOCK:
        return jnp.asarray(thresholds)
    SB = TEMPLATE_BLOCK
    Sp = -(-S // SB) * SB
    th = np.full(Sp, np.inf, np.float32)
    th[:S] = thresholds
    return jnp.asarray(th.reshape(Sp // SB, SB))


def _bank_statics(bank, nc):
    if bank.get("os"):
        return dict(demux="os", n_c=bank["n_c"], nc=int(nc),
                    nfft=bank["blk_fft"],
                    S=int(bank["sum_u"].shape[0]))
    if bank.get("demux"):
        return dict(demux=True, n_c=bank["n_c"], nc=int(nc),
                    nfft=bank["nfft2"], S=int(bank["sum_u"].shape[0]))
    return dict(demux=False, n_c=bank["n"], nc=int(nc), nfft=bank["nfft"],
                S=int(bank["sum_u"].shape[0]))


def _ds_of(x, arrs, demux, n_c, nc, nfft):
    if demux == "os":
        return _ds.ds_bank_demux_os(x, arrs[0], arrs[1], arrs[2], n_c, nc,
                                    nfft)
    if demux:
        return _ds.ds_bank_demux(x, arrs[0], arrs[1], arrs[2], n_c, nc,
                                 nfft)
    return _ds.ds_bank(x, arrs[0], arrs[1], arrs[2], n_c, nc, nfft)


# S-axis block bounding the per-chunk device-memory footprint
# (env-overridable for perf sweeps)
TEMPLATE_BLOCK = int(os.environ.get("DETEX_TPU_TEMPLATE_BLOCK", "128"))

# above this DS length the trigger extractor switches to the block-max
# pyramid (same outputs; the flat scan's [S, L] carry dominates memory
# traffic at large template counts)
PYRAMID_MIN_LEN = 4096


def _extract(v, t, buff_samps, max_trig):
    if v.shape[0] >= PYRAMID_MIN_LEN:
        return _triggers.extract_triggers_pyramid(v, t, buff_samps,
                                                  max_triggers=max_trig)
    return _triggers.extract_triggers_topk(v, t, buff_samps,
                                           max_triggers=max_trig)


def _trig_pm(buff_samps, max_trig):
    """Per-row trigger extraction from a masked DS row and its
    precomputed 128-sample block-max pyramid."""
    def trig_one(v, pm, t):
        idx, cnt = _triggers.extract_triggers_pyramid_pm(
            v, pm, t, buff_samps, max_triggers=max_trig)
        vals = jnp.where(idx >= 0, v[jnp.clip(idx, 0, v.shape[0] - 1)],
                         jnp.nan)
        return idx, vals, cnt
    return trig_one


def _chunk_fn(x, nv, arrs, thresholds, bins, demux, n_c, nc, nfft,
              buff_samps, max_trig, S, calc_hist=True, calc_triggers=True):
    """Process one chunk: DS for the whole bank + hist + triggers.
    ``nv`` is the number of valid DS samples (windows fully inside real
    data — ragged chunks are zero-padded to the bank's pad_len and the pad
    windows are masked out here).

    ``arrs`` is either a flat bank (small S) or pre-blocked
    [nB, TEMPLATE_BLOCK, ...] arrays from _bank_arrays (large
    matched-filter banks): blocks are processed with lax.map so complex
    spectra / irFFT intermediates stay bounded. ``S`` is the true
    (unpadded) detector count."""

    def finish(ds, th):
        pos = jnp.arange(ds.shape[-1])
        ds = jnp.where(pos[None, :] < nv, ds, -jnp.inf)
        hist = _hist_rows(ds, bins, calc_hist)
        maxds = jnp.max(ds, axis=-1)                           # [s]
        if not calc_triggers:
            nt = _no_trig(1, ds.shape[0])
            return hist, maxds, nt[0][0], nt[1][0], nt[2][0]

        def trig_one(v, t):
            idx, cnt = _extract(v, t, buff_samps, max_trig)
            vals = jnp.where(idx >= 0, v[jnp.clip(idx, 0, v.shape[0] - 1)],
                             jnp.nan)
            return idx, vals, cnt

        tidx, tval, tcnt = jax.vmap(trig_one)(ds, th)
        return hist, maxds, tidx, tval, tcnt

    def finish_os(ds, pyr, th):
        """OS path: ds is full block width with pad positions already
        -inf, and the pyramid gives the global max for free."""
        hist = _hist_rows(ds, bins, calc_hist)
        maxds = jnp.max(pyr, axis=-1)
        if not calc_triggers:
            nt = _no_trig(1, ds.shape[0])
            return hist, maxds, nt[0][0], nt[1][0], nt[2][0]
        tidx, tval, tcnt = jax.vmap(_trig_pm(buff_samps, max_trig))(
            ds, pyr, th)
        return hist, maxds, tidx, tval, tcnt

    if demux == "os":
        # chunk-shared prep (stats + windows + forward transform) hoisted
        # out of the template-block loop: XLA does not hoist it out of
        # the lax.map below, and at 8 blocks that is 8x the shared work
        osF, os_a, os_pw = _ds.os_prep_batch(x[None], n_c, nc, nfft)
        os_Lc = x.shape[0] // nc

    def run_one(blk_arrs, th):
        if demux == "os":
            ds, pyr = _ds.os_block_scan_batch(
                osF, os_a, os_pw, blk_arrs[0], blk_arrs[1], blk_arrs[2],
                n_c, nc, nfft, os_Lc, jnp.reshape(nv, (1,)))
            return finish_os(ds[0], pyr[0], th)
        return finish(_ds_of(x, blk_arrs, demux, n_c, nc, nfft), th)

    blocked = arrs[2].ndim == 3  # d_mask [nB, SB, Dmax] when pre-blocked
    if not blocked:
        return run_one(arrs, thresholds)

    def one_block(args):
        return run_one(args[:-1], args[-1])

    hist, maxds, tidx, tval, tcnt = jax.lax.map(
        one_block, arrs + (thresholds,))
    def cat(a):
        # [nB, SB, ...] -> [nB*SB, ...][:S]  (explicit sizes: a -1 here
        # divides by zero on the zero-capacity trigger arrays)
        return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])[:S]

    return cat(hist), cat(maxds), cat(tidx), cat(tval), cat(tcnt)


def _no_trig(B, S):
    """Zero-capacity trigger outputs for calc_triggers=False (the engine
    gates on maxima and re-verifies host-side; it never reads these)."""
    return (jnp.zeros((B, S, 0), jnp.int32), jnp.zeros((B, S, 0)),
            jnp.zeros((B, S), jnp.int32))


def _fold_block(F, a, power, Ufd2, su, dm, th, bins, NV, n_c, nc, blk_fft,
                L_c, buff_samps, max_trig, calc_hist, calc_triggers):
    """All B chunks against one (template-block of the) bank with folded
    ops: (hist [s, nbins] summed over chunks, maxds [B, s],
    tidx [B, s, K], tval, tcnt [B, s])."""
    B = F.shape[0]
    s = su.shape[0]
    ds, pyr = _ds.os_block_scan_batch(F, a, power, Ufd2, su, dm, n_c, nc,
                                      blk_fft, L_c, NV)
    maxds = pyr.max(axis=-1)                            # [B, s]
    dsf = ds.reshape(B * s, -1)
    hist = _hist_rows(dsf, bins, calc_hist)
    hist = hist.reshape(B, s, -1).sum(axis=0)           # [s, nbins]
    if not calc_triggers:
        return (hist, maxds) + _no_trig(B, s)
    thf = jnp.broadcast_to(th[None, :], (B, s)).reshape(B * s)
    tidx, tval, tcnt = jax.vmap(_trig_pm(buff_samps, max_trig))(
        dsf, pyr.reshape(B * s, -1), thf)
    K = tidx.shape[-1]
    return (hist, maxds, tidx.reshape(B, s, K), tval.reshape(B, s, K),
            tcnt.reshape(B, s))


def _fold_chunks_fn(X, NV, arrs, thresholds, bins, n_c, nc, blk_fft,
                    buff_samps, max_trig, S, calc_hist, calc_triggers=True):
    """Fold-batch OS scan body: every op instance covers the whole chunk
    batch (no lax.map over chunks) — see ops/ds.py os_prep_batch.
    Outputs match _chunk_fn's contract with the chunk sum already taken:
    (hist [S, nbins] summed over chunks, maxds [B, S], tidx [B, S, K],
    tval, tcnt).

    ``arrs`` is the flat (Ufd2, sum_u, d_mask) bank, or the template-
    blocked arrays of _bank_arrays: the chunk-shared prep then runs once
    for the whole batch and a lax.map walks the template blocks only.
    ``calc_triggers=False`` (the production engine's summary-only scan)
    skips the per-row trigger extraction; trigger outputs come back with
    zero capacity."""
    L_c = X.shape[1] // nc
    F, a, power = _ds.os_prep_batch(X, n_c, nc, blk_fft)

    def block(Ufd2, su, dm, th):
        return _fold_block(F, a, power, Ufd2, su, dm, th, bins, NV, n_c,
                           nc, blk_fft, L_c, buff_samps, max_trig,
                           calc_hist, calc_triggers)

    if arrs[2].ndim == 2:                   # flat bank
        return block(*arrs, thresholds)
    hist, maxds, tidx, tval, tcnt = jax.lax.map(
        lambda args: block(*args), arrs + (thresholds,))
    hist = hist.reshape(-1, hist.shape[-1])[:S]       # [S, nbins]

    def catb(x):
        # [nB, B, SB, ...] -> [B, nB*SB, ...][:, :S]  (explicit sizes: a
        # -1 here divides by zero on the zero-capacity trigger arrays)
        x = jnp.moveaxis(x, 0, 1)
        x = x.reshape((x.shape[0], x.shape[1] * x.shape[2]) + x.shape[3:])
        return x[:, :S]

    return hist, catb(maxds), catb(tidx), catb(tval), catb(tcnt)


@partial(jax.jit, static_argnames=("n_c", "nc", "blk_fft", "buff_samps",
                                   "max_trig", "S", "calc_hist",
                                   "calc_triggers"))
def _scan_chunks_fold_jit(X, NV, arrs, thresholds, bins, n_c, nc, blk_fft,
                          buff_samps, max_trig, S, calc_hist=True,
                          calc_triggers=True):
    return _fold_chunks_fn(X, NV, arrs, thresholds, bins, n_c, nc, blk_fft,
                           buff_samps, max_trig, S, calc_hist,
                           calc_triggers)


@partial(jax.jit, static_argnames=("demux", "n_c", "nc", "nfft",
                                   "buff_samps", "max_trig", "S",
                                   "calc_hist", "calc_triggers"))
def _scan_chunks_jit(X, NV, arrs, thresholds, bins, demux, n_c, nc, nfft,
                     buff_samps, max_trig, S, calc_hist=True,
                     calc_triggers=True):
    f = lambda xn: _chunk_fn(xn[0], xn[1], arrs, thresholds, bins,  # noqa
                             demux, n_c, nc, nfft, buff_samps, max_trig, S,
                             calc_hist, calc_triggers)
    # lax.map (not vmap): compiles the chunk body once — these are
    # million-sample chunks, so batching buys no fusion but multiplies the
    # program size (and compile time) by B
    hist, maxds, tidx, tval, tcnt = jax.lax.map(f, (X, NV))
    return hist.sum(axis=0), maxds, tidx, tval, tcnt


def _valid_lens(bank, nc, X, valid_lens):
    """Per-chunk count of valid DS samples (windows fully inside real
    data). Must never exceed the true output length — the OS scan path
    carries full block-grid width and masks on this."""
    n = bank["n"]
    if valid_lens is None:
        valid_lens = [X.shape[1]] * X.shape[0]
    return np.asarray([(int(v) - n) // nc + 1 for v in valid_lens],
                      np.int32)


def _os_fold_route(bank, st, B, Lc_mux, thresholds):
    """Shared kernel routing (single source of truth for scan_chunks,
    scan_chunks_sharded and the sharded devicePrep path — the same config
    must pick the same route everywhere the parity tests cover).

    Overlap-save banks take the fold-batch scan when its folded
    [B, S|TEMPLATE_BLOCK, Dmax, m, blk] intermediate fits the device's
    hbm_budget; everything else takes the per-chunk lax.map route.

    Returns (route, arrs, thresholds_dev):
      route "fold"    — fold-batch scan over the flat bank
      route "blocked" — fold-batch scan, lax.map over template blocks
      route None      — per-chunk lax.map path (_chunk_fn)
    """
    arrs = _bank_arrays(bank)
    th = _blocked_thresholds(bank, thresholds)
    if st["demux"] != "os":
        return None, arrs, th
    blocked = st["S"] > TEMPLATE_BLOCK
    rows = TEMPLATE_BLOCK if blocked else st["S"]
    if not _ds.fold_scan_fits(B, rows, int(bank["Dmax"]), st["n_c"],
                              st["nfft"], Lc_mux // st["nc"]):
        return None, arrs, th
    return ("blocked" if blocked else "fold"), arrs, th


def scan_chunks(X, bank, thresholds, nc, buff_samps, bins=None, max_trig=64,
                valid_lens=None, mesh=None, calc_hist=True,
                calc_triggers=True, _device_prep=False):
    """Batched scan: X [B, Lc] -> (hist, maxds, trig...).
    ``valid_lens`` (optional, [B]) gives each chunk's true multiplexed
    sample count when rows are zero-padded. With ``mesh`` the batch is
    chunk-sharded across the mesh (padded to a multiple of its size).
    ``calc_hist=False`` skips the per-detector DS histogram (its row sort
    is a large share of scan cost at big banks); hist returns zeros.
    ``calc_triggers=False`` (the production engine's mode — it gates on
    maxima and re-verifies triggered chunks host-side) skips the device
    trigger extraction; trigger outputs come back zero-capacity
    ([B, S, 0] / zero counts)."""
    if mesh is not None and mesh.size > 1:
        return scan_chunks_sharded(mesh, X, bank, thresholds, nc, buff_samps,
                                   bins=bins, max_trig=max_trig,
                                   valid_lens=valid_lens,
                                   calc_hist=calc_hist,
                                   calc_triggers=calc_triggers)
    fn, args, kw, route = scan_program(
        X, bank, thresholds, nc, buff_samps, bins=bins, max_trig=max_trig,
        valid_lens=valid_lens, calc_hist=calc_hist,
        calc_triggers=calc_triggers)
    _note_route(ROUTE_NAMES[route], device_prep=_device_prep)
    return fn(*args, **kw)


def scan_program(X, bank, thresholds, nc, buff_samps, bins=None,
                 max_trig=64, valid_lens=None, calc_hist=True,
                 calc_triggers=True):
    """The single-device scan_chunks dispatch as (jitted fn, args,
    static kwargs, route): ``fn(*args, **kw)`` runs the scan and
    ``fn.lower(*args, **kw).compile()`` gives the compiled program
    (memory_analysis, cost_analysis); ``route`` is _os_fold_route's."""
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    # NOTE: X may be a device array — never np.asarray it here (a full
    # device->host copy); only shapes are needed
    nv = jnp.asarray(_valid_lens(bank, nc, X, valid_lens))
    route, arrs, th = _os_fold_route(bank, st, int(X.shape[0]),
                                     int(X.shape[1]), thresholds)
    args = (jnp.asarray(X, jnp.float32), nv, arrs, th,
            jnp.asarray(bins, jnp.float32))
    kw = dict(n_c=st["n_c"], nc=st["nc"], buff_samps=int(buff_samps),
              max_trig=int(max_trig), S=st["S"], calc_hist=bool(calc_hist),
              calc_triggers=bool(calc_triggers))
    if route:
        return (_scan_chunks_fold_jit, args, dict(kw, blk_fft=st["nfft"]),
                route)
    return (_scan_chunks_jit, args,
            dict(kw, demux=st["demux"], nfft=st["nfft"]), route)


def _chunk_fn_raw(xc, Lv, H, arrs, thresholds, bins, n_c, nc, nfft,
                  buff_samps, max_trig, dec=1, calc_hist=True,
                  calc_triggers=True):
    """Raw-channel variant of _chunk_fn with fused device preprocessing."""
    from detex_tpu.ops.prep import ds_bank_demux_raw
    ds = ds_bank_demux_raw(xc, Lv, H, arrs[0], arrs[1], arrs[2], n_c, nc,
                           nfft, dec)
    nv = (Lv // dec) - n_c + 1
    pos = jnp.arange(ds.shape[-1])
    ds = jnp.where(pos[None, :] < nv, ds, -jnp.inf)
    hist = _hist_rows(ds, bins, calc_hist)
    maxds = jnp.max(ds, axis=-1)
    if not calc_triggers:
        nt = _no_trig(1, ds.shape[0])
        return hist, maxds, nt[0][0], nt[1][0], nt[2][0]

    def trig_one(v, th):
        idx, cnt = _extract(v, th, buff_samps, max_trig)
        vals = jnp.where(idx >= 0, v[jnp.clip(idx, 0, v.shape[0] - 1)],
                         jnp.nan)
        return idx, vals, cnt

    tidx, tval, tcnt = jax.vmap(trig_one)(ds, thresholds)
    return hist, maxds, tidx, tval, tcnt


@partial(jax.jit, static_argnames=("n_c", "nc", "nfft", "buff_samps",
                                   "max_trig", "dec", "calc_hist",
                                   "calc_triggers"))
def _scan_chunks_raw_jit(Xc, LV, H, arrs, thresholds, bins, n_c, nc, nfft,
                         buff_samps, max_trig, dec, calc_hist=True,
                         calc_triggers=True):
    f = lambda xn: _chunk_fn_raw(xn[0], xn[1], H, arrs, thresholds,  # noqa
                                 bins, n_c, nc, nfft, buff_samps, max_trig,
                                 dec, calc_hist, calc_triggers)
    hist, maxds, tidx, tval, tcnt = jax.lax.map(f, (Xc, LV))
    return hist.sum(axis=0), maxds, tidx, tval, tcnt


def scan_chunks_raw(Xc, lens, H, bank, thresholds, nc, buff_samps,
                    bins=None, max_trig=64, dec=1, mesh=None,
                    calc_hist=True, calc_triggers=True):
    """
    Batched scan from RAW channels with fused device preprocessing
    (detrend + spectral bandpass + optional spectral decimation):
    Xc [B, nc, L_raw] zero-padded channels, lens [B] true per-channel RAW
    sample counts. With ``mesh`` the batch is chunk-sharded across it.
    """
    if mesh is not None and mesh.size > 1:
        return scan_chunks_raw_sharded(mesh, Xc, lens, H, bank, thresholds,
                                       nc, buff_samps, bins=bins,
                                       max_trig=max_trig, dec=dec,
                                       calc_hist=calc_hist,
                                       calc_triggers=calc_triggers)
    if bank.get("os"):
        # overlap-save bank: run the batched device prep (detrend +
        # spectral bandpass + decimation) as its own jit producing
        # multiplexed chunks, then the overlap-save scan — the monolithic
        # per-chunk raw kernel below needs full-length spectra.
        from detex_tpu.ops import prep as _prep
        nfftp = (int(H.shape[0]) - 1) * 2 // int(dec)
        X, _ = _prep.prep_multiplex_batch(
            jnp.asarray(Xc, jnp.float32),
            jnp.asarray(lens, jnp.int32), H, nfftp, int(dec), int(nc))
        lens_mux = [(int(v) // int(dec)) * int(nc) for v in lens]
        return scan_chunks(X, bank, thresholds, nc, buff_samps, bins=bins,
                           max_trig=max_trig, valid_lens=lens_mux,
                           calc_hist=calc_hist, calc_triggers=calc_triggers,
                           _device_prep=True)
    if bins is None:
        bins = DEFAULT_BINS
    if not bank.get("demux"):
        raise ValueError("scan_chunks_raw requires a demuxed bank")
    _note_route("raw-demux", device_prep=True)
    arrs = (bank["Ufd2"], bank["sum_u"], bank["d_mask"])
    return _scan_chunks_raw_jit(
        jnp.asarray(Xc, jnp.float32), jnp.asarray(lens, jnp.int32), H,
        arrs, jnp.asarray(thresholds, jnp.float32),
        jnp.asarray(bins, jnp.float32), bank["n_c"], int(nc),
        bank["nfft2"], int(buff_samps), int(max_trig), int(dec),
        bool(calc_hist), bool(calc_triggers))


@lru_cache(maxsize=None)
def _sharded_scan_fn(mesh, demux, n_c, nc, nfft, buff_samps, max_trig, axis,
                     S, calc_hist=True, calc_triggers=True):
    """Build (once per static config) the jitted shard_map scan: chunks
    sharded over ``axis``, DS histogram merged with one psum."""

    def shard_body(Xs, NV, arrs, thresholds, bins):
        f = lambda xn: _chunk_fn(xn[0], xn[1], arrs, thresholds,    # noqa
                                 bins, demux, n_c, nc, nfft,
                                 buff_samps, max_trig, S, calc_hist,
                                 calc_triggers)
        hist, maxds, tidx, tval, tcnt = jax.lax.map(f, (Xs, NV))
        hist = jax.lax.psum(hist.sum(axis=0), axis)
        return hist, maxds, tidx, tval, tcnt

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(), P(), P()),
                   out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                   check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _sharded_scan_fold_fn(mesh, n_c, nc, blk_fft, buff_samps, max_trig,
                          axis, S, calc_hist=True, calc_triggers=True):
    """Sharded fold-batch scan: each device folds ITS chunk shard into
    single op instances (flat or template-blocked bank, like the
    single-device fold); histograms merge with one psum."""

    def shard_body(Xs, NV, arrs, thresholds, bins):
        hist, maxds, tidx, tval, tcnt = _fold_chunks_fn(
            Xs, NV, arrs, thresholds, bins, n_c, nc, blk_fft, buff_samps,
            max_trig, S, calc_hist, calc_triggers)
        hist = jax.lax.psum(hist, axis)
        return hist, maxds, tidx, tval, tcnt

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(), P(), P()),
                   out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                   check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _sharded_scan_raw_fn(mesh, n_c, nc, nfft, buff_samps, max_trig, dec,
                         axis, calc_hist=True, calc_triggers=True):
    """Sharded variant of the raw-channel (fused devicePrep) scan."""

    def shard_body(Xs, LV, H, arrs, thresholds, bins):
        f = lambda xn: _chunk_fn_raw(xn[0], xn[1], H, arrs,         # noqa
                                     thresholds, bins, n_c, nc, nfft,
                                     buff_samps, max_trig, dec, calc_hist,
                                     calc_triggers)
        hist, maxds, tidx, tval, tcnt = jax.lax.map(f, (Xs, LV))
        hist = jax.lax.psum(hist.sum(axis=0), axis)
        return hist, maxds, tidx, tval, tcnt

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(), P(), P(), P()),
                   out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                   check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _sharded_scan_raw_os_fn(mesh, n_c, nc, blk_fft, buff_samps, max_trig,
                            dec, nfftp, n_tpl, axis, S, calc_hist, route,
                            calc_triggers=True):
    """Sharded devicePrep scan for OVERLAP-SAVE banks: each device runs
    the batched device prep (detrend + spectral bandpass + decimation,
    ops/prep.prep_multiplex_batch) on ITS raw-channel shard, then the
    scan route the single-device path would pick ("fold", "blocked", or
    None = per-chunk OS lax.map; _os_fold_route). Histograms merge with
    one psum."""
    from detex_tpu.ops import prep as _prep

    def shard_body(Xc, LV, H, arrs, thresholds, bins):
        X, lens_mux = _prep.prep_multiplex_batch(Xc, LV, H, nfftp, dec, nc)
        # valid DS samples per chunk; padded (LV=0) rows clamp to 0 ==
        # fully masked, matching _pad_batch's zero-length chunk contract
        NV = jnp.maximum((lens_mux - n_tpl) // nc + 1, 0).astype(jnp.int32)
        if route:
            hist, maxds, tidx, tval, tcnt = _fold_chunks_fn(
                X, NV, arrs, thresholds, bins, n_c, nc, blk_fft,
                buff_samps, max_trig, S, calc_hist, calc_triggers)
        else:
            f = lambda xn: _chunk_fn(xn[0], xn[1], arrs,        # noqa
                                     thresholds, bins, "os", n_c, nc,
                                     blk_fft, buff_samps, max_trig, S,
                                     calc_hist, calc_triggers)
            hist, maxds, tidx, tval, tcnt = jax.lax.map(f, (X, NV))
            hist = hist.sum(axis=0)
        hist = jax.lax.psum(hist, axis)
        return hist, maxds, tidx, tval, tcnt

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(), P(), P(), P()),
                   out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                   check_vma=False)
    return jax.jit(fn)


def scan_chunks_sharded(mesh, X, bank, thresholds, nc, buff_samps,
                        bins=None, max_trig=64, axis="chunks",
                        valid_lens=None, calc_hist=True,
                        calc_triggers=True):
    """
    Multi-device scan of chunk batch X [B, Lc]; B is padded up to a
    multiple of the mesh size with fully-masked chunks and the outputs
    sliced back.

    Returns (hist [S, nbins] merged via psum, maxds [B, S],
    trig_idx [B, S, K], trig_val [B, S, K], trig_count [B, S]).
    """
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    _require_host_array(X, "scan_chunks_sharded")
    X = np.asarray(X, np.float32)
    nv = _valid_lens(bank, nc, X, valid_lens)
    X, nv, B = _pad_batch(mesh.size, X, nv)
    # kernel routing decided on the PER-SHARD batch size
    route, arrs, th = _os_fold_route(bank, st, int(X.shape[0]) // mesh.size,
                                     int(X.shape[1]), thresholds)
    _note_route(ROUTE_NAMES[route], sharded=True)
    if route:
        fn = _sharded_scan_fold_fn(mesh, st["n_c"], int(nc), st["nfft"],
                                   int(buff_samps), int(max_trig), axis,
                                   st["S"], bool(calc_hist),
                                   bool(calc_triggers))
    else:
        fn = _sharded_scan_fn(mesh, st["demux"], st["n_c"], int(nc),
                              st["nfft"], int(buff_samps), int(max_trig),
                              axis, st["S"], bool(calc_hist),
                              bool(calc_triggers))
    hist, maxds, tidx, tval, tcnt = fn(
        jnp.asarray(X), jnp.asarray(nv), arrs, th,
        jnp.asarray(bins, jnp.float32))
    return hist, maxds[:B], tidx[:B], tval[:B], tcnt[:B]


def scan_chunks_raw_sharded(mesh, Xc, lens, H, bank, thresholds, nc,
                            buff_samps, bins=None, max_trig=64, dec=1,
                            axis="chunks", calc_hist=True,
                            calc_triggers=True):
    """Multi-device raw-channel scan (fused devicePrep); B padded to a
    multiple of the mesh size like scan_chunks_sharded. Overlap-save
    banks run prep + the overlap-save scan inside the shard body (one
    program per device, no host round trip)."""
    if bins is None:
        bins = DEFAULT_BINS
    if not bank.get("demux"):
        raise ValueError("scan_chunks_raw_sharded requires a demuxed bank")
    _require_host_array(Xc, "scan_chunks_raw_sharded")
    Xc = np.asarray(Xc, np.float32)
    lens = np.asarray(lens, np.int32)
    Xc, lens, B = _pad_batch(mesh.size, Xc, lens)
    if bank.get("os"):
        st = _bank_statics(bank, nc)
        nfftp = (int(H.shape[0]) - 1) * 2 // int(dec)
        Bs = Xc.shape[0] // mesh.size
        L_mux = (int(Xc.shape[2]) // int(dec)) * int(nc)
        # routing decided on the PER-SHARD batch (shape probe only)
        route, arrs, th = _os_fold_route(bank, st, Bs, L_mux, thresholds)
        _note_route(ROUTE_NAMES[route], sharded=True, device_prep=True)
        fn = _sharded_scan_raw_os_fn(
            mesh, st["n_c"], int(nc), st["nfft"], int(buff_samps),
            int(max_trig), int(dec), nfftp, int(bank["n"]), axis, st["S"],
            bool(calc_hist), route, bool(calc_triggers))
        hist, maxds, tidx, tval, tcnt = fn(
            jnp.asarray(Xc), jnp.asarray(lens), H, arrs, th,
            jnp.asarray(bins, jnp.float32))
        return hist, maxds[:B], tidx[:B], tval[:B], tcnt[:B]
    _note_route("raw-demux", sharded=True, device_prep=True)
    fn = _sharded_scan_raw_fn(mesh, bank["n_c"], int(nc), bank["nfft2"],
                              int(buff_samps), int(max_trig), int(dec), axis,
                              bool(calc_hist), bool(calc_triggers))
    hist, maxds, tidx, tval, tcnt = fn(
        jnp.asarray(Xc), jnp.asarray(lens), H,
        (bank["Ufd2"], bank["sum_u"], bank["d_mask"]),
        jnp.asarray(thresholds, jnp.float32), jnp.asarray(bins, jnp.float32))
    return hist, maxds[:B], tidx[:B], tval[:B], tcnt[:B]
