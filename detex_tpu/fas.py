"""
False-alarm statistics (empirical null estimation) — reference detex/fas.py.

Random continuous chunks are screened with a classic STA/LTA noise veto,
scanned with the same device DS kernel the detector uses
(detex_tpu.ops.ds == reference _MPXSSCorr fas.py:120-134), histogrammed,
and fit with a beta distribution whose inverse survival function sets the
detection threshold for the configured Pf.
"""
from __future__ import annotations

import numpy as np
import scipy.stats

import detex_tpu
from detex_tpu import profiling as _prof
from detex_tpu import construct as _construct
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.ops import ds as _ds
from detex_tpu.ops.stalta import classic_sta_lta


def _initFAS(TRDF, conDatNum, cluster, fetcher, LTATime=5, STATime=0.5,
             numBins=401, dtype="double", staltalimit=7.5, issubspace=True,
             utcstart=None, utcend=None, reverseTemplates=False):
    """
    Sample random continuous chunks and fit the DS null distribution for
    each subspace/singleton row of TRDF (reference fas.py:23-86). Returns a
    list of dicts: {'bins','hist','betadist','nnlf'} per row.

    reverseTemplates=True scans with time-reversed basis vectors instead —
    the Slinkard (2014) reverse-template null carried by the reference's
    legacy matched-filter engine (extras/xcorr.py calcReverse), useful when
    quiet continuous data are scarce.
    """
    TRDF = TRDF.reset_index(drop=True)
    results = [{} for _ in range(len(TRDF))]
    histBins = np.linspace(-.01, 1, num=numBins)
    conLen = fetcher.conDatDuration + fetcher.conBuff

    # load every row's detector matrix up front
    rows = []
    for ind, row in TRDF.iterrows():
        results[ind]["bins"] = histBins
        if issubspace:
            U, Nc, sr = _loadMPSubSpace(row)
        else:
            U, Nc, sr = _loadMPSingles(row)
        if reverseTemplates:
            U = np.ascontiguousarray(U[:, ::-1])
        rows.append((ind, row, U, int(Nc), float(sr)))

    # group rows per (station, Nc, sr): the random-chunk sampler is
    # deterministic (data/fetcher._divideIntoChunks seed), so every row of
    # a station draws the SAME null chunks — the reference re-fetched,
    # re-filtered and re-screened them once PER DETECTOR (fas.py:23-117);
    # here the chunks are collected once and the whole detector group is
    # scanned with banked device calls
    by_sta = {}
    for ent in rows:
        key = (ent[1].Station, ent[3], ent[4])
        by_sta.setdefault(key, []).append(ent)
    for (sta_full, Nc, sr), ents in by_sta.items():
        sta = sta_full.split(".")[1]
        stakey = cluster.stakey[cluster.stakey.STATION == sta]
        utc1 = UTCDateTime(stakey.iloc[0].STARTTIME) if utcstart is None \
            else UTCDateTime(utcstart)
        utc2 = UTCDateTime(stakey.iloc[0].ENDTIME) if utcend is None \
            else UTCDateTime(utcend)
        filt = cluster.filt
        deci = cluster.decimate
        with _prof.stage("fas.collect_chunks"):
            accepted, count, scount = _collectChunks(
                fetcher, stakey, utc1, utc2, filt, deci, dtype, conDatNum,
                Nc, STATime, LTATime, staltalimit)
        if scount < conDatNum:
            # scount = chunks that survived screening; count = chunks tried
            detex_tpu.log(__name__, "only %d of the requested %d null "
                          "chunks usable on %s (%d tried), using all "
                          "available" % (scount, conDatNum, sta, count),
                          level="warning")
        sratio = float(scount) / max(count, 1)
        if sratio <= .25:
            detex_tpu.log(__name__, "sta/lta req of %s failing on station "
                          "%s, dropping sta/lta requirement"
                          % (staltalimit, sta), level="warning", pri=True)
            accepted, count, scount = _collectChunks(
                fetcher, stakey, utc1, utc2, filt, deci, dtype, conDatNum,
                Nc, STATime, LTATime, None)
        if len(accepted) == 0:
            detex_tpu.log(__name__, "Could not calculate FAS for %s %s"
                          % (sta_full, ents[0][1].Name), level="error")
        # one bank per template length; DS of every row in the group from
        # the same batched device calls. Trim quantization (subspace.py
        # TRIM_QUANTUM) keeps the by_n ladder O(1); the bank shapes are
        # padded to the shared row/basis-dim ladders so every station's
        # group reuses ONE compiled program per rung (the same bank
        # shapes the detection engine compiles).
        by_n = {}
        for ent in ents:
            by_n.setdefault(ent[2].shape[1], []).append(ent)
        for n, grp in sorted(by_n.items()):
            dmax = max(e[2].shape[0] for e in grp)
            bank = _ds.build_bank([e[2] for e in grp], Nc,
                                  int(conLen * sr * Nc),
                                  pad_S=_ds.pad_rows(len(grp)),
                                  min_dmax=_ds.pad_dims(dmax))
            dsmats = [[] for _ in grp]
            BATCH = 8
            with _prof.stage("fas.scan"):
                for s in range(0, len(accepted), BATCH):
                    for out in _ds.run_bank_batch(accepted[s:s + BATCH],
                                                  bank, Nc):
                        for gi in range(len(grp)):
                            dsmats[gi].append(out[gi])
            for gi, (ind, row, U, _, _) in enumerate(grp):
                with _prof.stage("fas.fit"):
                    dss = np.concatenate(dsmats[gi]).astype(
                        np.float64 if dtype == "double" else np.float32)
                    results[ind]["hist"] = np.histogram(dss,
                                                        bins=histBins)[0]
                    clipped = np.clip(dss, 1e-12, 1 - 1e-12)
                    betaparams = scipy.stats.beta.fit(clipped, floc=0,
                                                      fscale=1)
                    results[ind]["betadist"] = betaparams
                    results[ind]["nnlf"] = scipy.stats.beta.nnlf(betaparams,
                                                                 clipped)
                    # normal-distribution null, carried by the reference's
                    # legacy matched-filter engine (extras/xcorr.py
                    # trigCon 2/3)
                    results[ind]["normdist"] = scipy.stats.norm.fit(dss)
    return results


def _collectChunks(fetcher, stakey, utc1, utc2, filt, deci, dtype,
                   conDatNum, Nc, sta, lta, limit):
    """Fetch, filter, STA/LTA-screen and multiplex the deterministic
    random null chunks for one station (reference fas.py:89-117 minus the
    per-detector DS, which the caller batches per station)."""
    stgen = fetcher.getConData(stakey, utcstart=utc1, utcend=utc2,
                               randSamps=conDatNum * 4)
    count = 0
    scount = 0
    accepted = []
    for st in stgen:
        if st is None or len(st) < 1:
            continue
        count += 1
        st = _construct._applyFilter(st, filt, deci, dtype)
        if st is None or len(st) < 1:
            continue
        if not _checkSTALTA(st, filt, sta, lta, limit):
            continue
        if scount >= conDatNum:
            break
        accepted.append(_construct.multiplex(st, Nc))
        scount += 1
    if count == 0:
        detex_tpu.log(__name__, "Could not get any data for %s"
                      % stakey.STATION.iloc[0], level="error")
    return accepted, count, scount


def _loadMPSubSpace(row):
    """U matrix from the used left singular vectors
    (reference fas.py:153-172)."""
    if not isinstance(row.UsedSVDKeys, list):
        detex_tpu.log(__name__, "SVD not defined, run SVD before FAS",
                      level="error")
    chans = list(row.Channels.values())
    if not all(x == chans[0] for x in chans):
        detex_tpu.log(__name__, "all events in subspace do not share "
                      "channels", level="error")
    Nc = len(chans[0])
    U = np.array([row.SVD[x] for x in row.UsedSVDKeys])
    sr = list(row.Stats.values())[0]["sampling_rate"]
    return U, Nc, sr


def _loadMPSingles(row):
    """Normalized trimmed singleton waveform (reference fas.py:137-150)."""
    Nc = list(row.Stats.values())[0]["Nc"]
    sts = row.SampleTrims["Starttime"]
    ste = row.SampleTrims["Endtime"]
    arr = np.array([row.MPtd[x][sts:ste] for x in row.MPtd.keys()])
    U = np.array([x / np.linalg.norm(x) for x in arr])
    sr = list(row.Stats.values())[0]["sampling_rate"]
    return U, Nc, sr


def _checkSTALTA(st, filt, STATime, LTATime, limit):
    """Reject chunks with transient signals via classic STA/LTA on the Z (or
    first) component (reference fas.py:175-205)."""
    if limit is None:
        return True
    if len(st) < 1:
        return False
    stz = st.select(component="Z")
    tr = stz[0] if len(stz) > 0 else st[0]
    sr = tr.stats.sampling_rate
    cft = classic_sta_lta(tr.data, STATime * sr, LTATime * sr)
    if np.max(cft) <= limit:
        return True
    detex_tpu.log(__name__, "%s fails sta/lta req of %s between %s and %s"
                  % (tr.stats.station, limit, tr.stats.starttime,
                     tr.stats.endtime), level="warning")
    return False
