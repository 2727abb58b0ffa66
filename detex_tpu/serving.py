"""
Deployment artifacts + high-throughput scanning (the production path).

The reference persists detector state only as whole-object pickles
(subspace.py:2018-2026). detex_tpu additionally exports detectors as a
plain ``.npz`` artifact (no pickle, no framework objects) that a serving
process can load and scan with the fused device kernels — the explicit
serialized model state SURVEY.md section 5.4 calls for.

    detex_tpu.serving.export_detectors(ss, "detectors.npz")
    dep = detex_tpu.serving.load_detectors("detectors.npz")
    out = detex_tpu.serving.scan_station(dep, "TA.S00", chunk_matrix)
"""
from __future__ import annotations

import json

import numpy as np

import detex_tpu
from detex_tpu.ops import ds as _ds
from detex_tpu.parallel import scan as _scan


def export_detectors(ss, path="detectors.npz", useSingles=True):
    """
    Export every SVD-defined subspace (and picked singleton) of a SubSpace
    instance into one npz: per detector U [D, n], threshold, offsets, mags,
    events, plus station metadata (nc, sampling rate, filter params).
    """
    arrays = {}
    meta = {"stations": {}, "filt": list(ss.clusters.filt or []),
            "decimate": ss.clusters.decimate, "version": 1}
    for sta in ss.Stations:
        dets = []
        frames = []
        if sta in ss.ssStations:
            frames.append(("ss", ss.subspaces[sta]))
        if useSingles and sta in ss.singStations:
            frames.append(("sg", ss.singles[sta]))
        nc = None
        sr = None
        for kind, df in frames:
            for _, row in df.iterrows():
                if kind == "ss":
                    if not row.SVDdefined:
                        continue
                    U = np.array([row.SVD[x] for x in row.UsedSVDKeys])
                    if "Starttime" in row.SampleTrims:
                        pass  # U already built from trimmed aligned wfs
                else:
                    if not row.SampleTrims:
                        continue
                    mptd = list(row.MPtd.values())[0]
                    s0 = row.SampleTrims["Starttime"]
                    s1 = row.SampleTrims["Endtime"]
                    upr = mptd[s0:s1]
                    U = np.array([upr / np.linalg.norm(upr)])
                stats0 = list(row.Stats.values())[0]
                nc = stats0["Nc"]
                sr = stats0["sampling_rate"]
                key = "%s__%s" % (sta, row.Name)
                arrays["U__" + key] = U.astype(np.float32)
                dets.append(dict(
                    name=row.Name, kind=kind,
                    threshold=float(row.Threshold),
                    offsets=[float(x) for x in np.atleast_1d(row.Offsets)],
                    mags=[float(row.Stats[e]["magnitude"])
                          for e in row.Events],
                    events=list(row.Events)))
        if dets:
            meta["stations"][sta] = dict(nc=int(nc), sr=float(sr),
                                         detectors=dets)
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez(path, **arrays)
    return path


def load_detectors(path, chunk_sec=3600.0, conBuff=120.0):
    """
    Load an exported detector artifact and build per-station device banks
    sized for ``chunk_sec + conBuff`` second chunks.

    Returns {station: {"banks": [bank,...], "names": [...],
    "thresholds": np[S], "offsets": {...}, "nc": int, "sr": float}}.
    """
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    out = {}
    for sta, sm in meta["stations"].items():
        nc = sm["nc"]
        sr = sm["sr"]
        data_len = int((chunk_sec + conBuff) * sr * nc)
        by_n = {}
        for det in sm["detectors"]:
            U = z["U__%s__%s" % (sta, det["name"])]
            by_n.setdefault(U.shape[1], []).append((det, U))
        banks = []
        for n, items in sorted(by_n.items()):
            bank = _ds.build_bank([u for _, u in items], nc, data_len)
            bank["names"] = [d["name"] for d, _ in items]
            bank["thresholds"] = np.array([d["threshold"]
                                           for d, _ in items], np.float32)
            banks.append(bank)
        out[sta] = dict(banks=banks, nc=nc, sr=sr, meta=sm,
                        chunk_sec=chunk_sec, conBuff=conBuff,
                        filt=list(meta.get("filt") or []) or None,
                        dec=int(meta.get("decimate") or 1))
    return out


def scan_station(dep, sta, chunks, mesh=None, bins=None, buff_sec=20.0,
                 max_trig=64, valid_lens=None, calc_hist=True):
    """
    Scan a [B, Lc] matrix of multiplexed chunks for one station against all
    of its detector banks; single-device or mesh-sharded.

    ``valid_lens`` ([B], optional) gives each chunk's true multiplexed
    sample count when rows are zero-padded; DS windows straddling the
    real-data/pad boundary are masked out of histograms, maxima and trigger
    extraction (like the detection engine's path). Defaults to the full
    row width.

    Returns list of per-bank dicts: {names, hist [S, nbins], maxds [B, S],
    trig_idx, trig_val, trig_count}.

    ``hist`` uses np.histogram's binning on every backend; counts can
    still move by one bin where a float32 DS lands within one ULP of an
    edge (PARITY.md, "DS histograms").
    """
    sd = dep[sta]
    nc, sr = sd["nc"], sd["sr"]
    buff = int(buff_sec * sr)
    results = []
    chunks = np.asarray(chunks, np.float32)
    if valid_lens is None:
        valid_lens = np.full(chunks.shape[0], chunks.shape[1], np.int64)
    else:
        valid_lens = np.asarray(valid_lens, np.int64)
    for bank in sd["banks"]:
        pad = bank["pad_len"]
        if chunks.shape[1] < pad:
            padded = np.zeros((chunks.shape[0], pad), np.float32)
            padded[:, :chunks.shape[1]] = chunks
        else:
            padded = chunks[:, :pad]
        vlens = np.minimum(valid_lens, pad)
        hist, maxds, ti, tv, tc = _scan.scan_chunks(
            padded, bank, bank["thresholds"], nc, buff, bins=bins,
            max_trig=max_trig, valid_lens=vlens, mesh=mesh,
            calc_hist=calc_hist)
        results.append(dict(names=bank["names"], hist=np.asarray(hist),
                            maxds=np.asarray(maxds),
                            trig_idx=np.asarray(ti),
                            trig_val=np.asarray(tv),
                            trig_count=np.asarray(tc)))
    return results


def _bank_H(bank, nc, filt, dec, sr):
    """Spectral response for the device prep, cached on the bank —
    the same formula the detection engine uses (detect._prepareDetectors:
    zero-phase |H|^2 over dec * nfftp bins at the RAW rate; overlap-save
    banks carry no full-length FFT size, so it is recomputed with the
    demux-bank formula)."""
    if "H" not in bank:
        import jax.numpy as jnp
        from detex_tpu.ops import prep as _prep
        raw_sr = sr * dec
        if bank.get("os"):
            nfftp = 2 ** int(bank["pad_len"] // nc
                             + bank["n_c"]).bit_length()
        else:
            nfftp = bank["nfft2"]
        nbins = dec * nfftp
        if filt:
            if filt[1] >= sr / 2.0 and dec > 1:
                raise ValueError(
                    "device decimation needs the bandpass high corner "
                    "below the decimated Nyquist (%.3g Hz)" % (sr / 2.0))
            bank["H"] = _prep.butter_response(filt, raw_sr, nbins,
                                              zerophase=bool(filt[3]))
        else:
            bank["H"] = jnp.ones(nbins // 2 + 1, jnp.float32)
    return bank["H"]


def scan_station_raw(dep, sta, chans, lens=None, mesh=None, bins=None,
                     buff_sec=20.0, max_trig=64, calc_hist=True):
    """
    Scan RAW channel chunks [B, nc, L_raw] (unfiltered, undecimated, as
    read from the wire/archive): detrend + zero-phase bandpass + optional
    decimation run ON DEVICE (the engine's devicePrep path,
    ops/prep.py), then the batched DS scan — no host
    preprocessing in the hot loop. The artifact's ``filt``/``decimate``
    metadata define the preprocessing, so results match scan_station on
    host-prepped chunks to the spectral-vs-SOS filter tolerance
    (~1e-3 DS; see detect.devicePrepEps).

    ``lens`` ([B], optional) gives each chunk's true RAW per-channel
    sample count for zero-padded rows. Returns the same per-bank dicts as
    scan_station. Requires demuxed banks (template length divisible by
    nc — always true for multiplexed detectors).
    """
    sd = dep[sta]
    nc, sr = sd["nc"], sd["sr"]
    dec = int(sd.get("dec") or 1)
    filt = sd.get("filt")
    buff = int(buff_sec * sr)
    chans = np.asarray(chans, np.float32)
    if chans.ndim != 3 or chans.shape[1] != nc:
        raise ValueError("chans must be [B, nc=%d, L_raw]" % nc)
    B, _, L_raw = chans.shape
    if lens is None:
        lens = np.full(B, L_raw, np.int64)
    lens = np.asarray(lens, np.int64)
    results = []
    for bank in sd["banks"]:
        if not bank.get("demux"):
            raise ValueError("scan_station_raw needs demuxed banks "
                             "(template length divisible by nc)")
        Lp = (bank["pad_len"] // nc) * dec
        if L_raw < Lp:
            padded = np.zeros((B, nc, Lp), np.float32)
            padded[:, :, :L_raw] = chans
        else:
            padded = chans[:, :, :Lp]
        vl = np.minimum(lens, Lp)
        H = _bank_H(bank, nc, filt, dec, sr)
        hist, maxds, ti, tv, tc = _scan.scan_chunks_raw(
            padded, vl, H, bank, bank["thresholds"], nc, buff_samps=buff,
            bins=bins, max_trig=max_trig, dec=dec, mesh=mesh,
            calc_hist=calc_hist)
        results.append(dict(names=bank["names"], hist=np.asarray(hist),
                            maxds=np.asarray(maxds),
                            trig_idx=np.asarray(ti),
                            trig_val=np.asarray(tv),
                            trig_count=np.asarray(tc)))
    return results


def triggers_to_frame(dep, sta, results, chunk_starts):
    """
    Convert scan_station outputs into a detections DataFrame compatible
    with the ss_df schema (DS, STMP, Name, Sta, MSTAMPmin, MSTAMPmax).
    """
    import pandas as pd
    sd = dep[sta]
    sr = sd["sr"]
    rows = []
    det_meta = {d["name"]: d for d in sd["meta"]["detectors"]}
    for res in results:
        for b, t0 in enumerate(np.asarray(chunk_starts, np.float64)):
            for s, name in enumerate(res["names"]):
                cnt = int(res["trig_count"][b, s])
                for k in range(cnt):
                    idx = int(res["trig_idx"][b, s, k])
                    ds = float(res["trig_val"][b, s, k])
                    times = idx / sr + t0
                    offs = det_meta[name]["offsets"]
                    rows.append(dict(DS=ds, STMP=times, Name=name, Sta=sta,
                                     MSTAMPmin=times - max(offs),
                                     MSTAMPmax=times - min(offs)))
    return pd.DataFrame(rows)
