"""
Continuous-data subspace detection engine — reference detex/detect.py
rebuilt around batched device kernels.

Per station the detectors are packed into fixed-shape banks (grouped by
template length); each continuous chunk is multiplexed on host, padded to a
fixed length (one XLA compile per station), and the DS of *all* detectors is
produced by one fused device call (rfft -> broadcast conj-multiply ->
irfft -> rolling-power normalization -> stride). Histogramming runs on
device; only maxima, trigger indices and (rarely) triggered DS vectors cross
back to host. Trigger suppression runs as an on-device while_loop with the
reference's exact zeroing semantics.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd

import detex_tpu
from detex_tpu import profiling as _prof
from detex_tpu import util as _util
from detex_tpu.construct import _applyFilter, multiplex
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.ops import ds as _ds
from detex_tpu.ops import stalta as _stalta
from detex_tpu.ops import triggers as _triggers

MAX_TRIGGERS = 4096  # reference kill switch at 4000 (detect.py:433-436)

#: detection-row columns (reference _CreateCoeffArray's Sar frame)
SAR_COLS = ["DS", "DS_STALTA", "STMP", "Name", "Sta", "MSTAMPmin",
            "MSTAMPmax", "Mag", "SNR", "ProEnMag"]


def _keep_dev_batch_bytes():
    """HBM budget for the scan input batches the engine keeps alive so the
    dense re-verify can gather triggered chunks without re-uploading them
    The engine retains up to ``_inflight_depth + 1``
    batches at once (in-flight + the one being materialized), each
    batchSize x pad_len float32 — unbounded growth at large batch/chunk
    configs could exhaust device memory mid-station, so batches
    larger than this budget are NOT retained and the re-verify falls back
    to re-uploading its (few) triggered chunks. Default 2 GiB; override
    with DETEX_TPU_REVERIFY_KEEP_MB."""
    return int(float(os.environ.get("DETEX_TPU_REVERIFY_KEEP_MB",
                                    "2048")) * (1 << 20))


class _SSDetex(object):
    """Run subspace/singleton detections or event classification
    (reference detect.py:22-218)."""

    def __init__(self, TRDF, utcStart, utcEnd, cfetcher, clusters, subspaceDB,
                 trigCon, triggerLTATime, triggerSTATime, multiprocess,
                 calcHist, dtype, estimateMags, classifyEvents, eventCorFile,
                 utcSaves, fillZeros, issubspace=True, batchSize=8,
                 devicePrep=False, staltaThreshold=None):
        self.staltaThreshold = staltaThreshold
        self.batchSize = int(batchSize)
        self.devicePrep = bool(devicePrep)
        # device decimation factor (spectral resample in the device prep)
        self.dpDec = int(clusters.decimate or 1) if devicePrep else 1
        if self.devicePrep and (classifyEvents is not None or
                                utcSaves is not None or batchSize <= 1 or
                                trigCon != 0):
            detex_tpu.log(__name__, "devicePrep requires the batched scan "
                          "path (trigCon=0, no classifyEvents/utcSaves, "
                          "batchSize > 1); falling back to host "
                          "preprocessing", level="warning", pri=True)
            self.devicePrep = False
        # devicePrep trigger-gate tolerance: the device spectral filter
        # differs from the host SOS filter by circular-convolution edge
        # effects, so the device maxds can land slightly below the host-path
        # DS. Chunks within this margin below threshold are re-verified
        # through the exact host path (false gate hits only cost a host
        # recompute; detections themselves always come from the host path).
        self.devicePrepEps = 0.005
        self.utcStart = utcStart
        self.utcEnd = utcEnd
        self.filt = clusters.filt
        self.decimate = clusters.decimate
        self.triggerLTATime = triggerLTATime
        self.triggerSTATime = triggerSTATime
        self.calcHist = calcHist
        self.dtype = dtype
        self.estimateMags = estimateMags
        self.eventCorFile = eventCorFile
        self.utcSaves = utcSaves
        self.fillZeros = fillZeros
        self.issubspace = issubspace
        self.stakey = clusters.stakey
        self.classifyEvents = classifyEvents
        self.trigCon = trigCon
        self.subspaceDB = subspaceDB

        if classifyEvents is not None:
            self.eveKey = _util.readKey(classifyEvents, "template")
            fetcher = clusters.fetcher
            dur = fetcher.timeBeforeOrigin + fetcher.timeAfterOrigin
        else:
            fetcher = cfetcher
            dur = fetcher.conDatDuration + fetcher.conBuff
        self.fetcher = fetcher
        self.dataLength = dur

        if utcSaves is not None:
            try:
                ts = [UTCDateTime(x).timestamp for x in utcSaves]
            except (ValueError, TypeError):
                detex_tpu.log(__name__, "utcSaves must be an iterable of "
                              "UTCDateTime-readable objects", level="error")
            self.utcSaves = np.array(ts)
            self.UTCSaveList = []
        self.eventCorList = []

        self.hist = {}
        if calcHist:
            self.hist["Bins"] = np.linspace(0, 1, num=401)

        # in-flight device-batch queue: batches are DISPATCHED (async) and
        # only materialized one dispatch later, so the host preps the next
        # batch — or the next STATION's banks — while the device computes.
        # The queue spans station boundaries (SURVEY §2: don't let the
        # device idle during per-station host prep).
        from collections import deque
        self._inflight = deque()
        self._inflight_depth = 1

        for sta in TRDF.keys():
            DFsta = TRDF[sta].reset_index(drop=True)
            TRDF[sta] = DFsta
            if len(DFsta) > 0:
                self.hist[sta] = self._corStations(DFsta, sta)
            if classifyEvents is not None and len(self.eventCorList) > 0:
                DFeve = pd.concat(self.eventCorList, ignore_index=True)
                DFeve.to_pickle("%s_%s.pkl" % (self.eventCorFile, sta))
                self.eventCorList = []
        self._drainInflight()
        if utcSaves is not None and len(getattr(self, "UTCSaveList", [])) > 0:
            DFutc = pd.concat(self.UTCSaveList, ignore_index=True)
            DFutc.to_pickle("UTCsaves.pkl")

    # ------------------------------------------------------------------
    def _corStations(self, DFsta, sta):
        """Prepare one station's detector banks and stream the data
        (reference detect.py:111-135)."""
        skey = self.stakey
        stakey = skey[skey.STATION == sta.split(".")[1]]
        channels = _getChannels(DFsta)
        samplingRates = _getSampleRates(DFsta)
        if channels is None or samplingRates is None:
            return None
        threshold = {x.Name: x.Threshold for _, x in DFsta.iterrows()}
        names = sorted(DFsta.Name.values)
        samplingRate = samplingRates[0]
        return self._corDat(threshold, sta, channels, names, DFsta,
                            samplingRate, stakey)

    def _prepareDetectors(self, DFsta, sta, channels, samplingRate):
        """
        Pack detectors into fixed-shape banks (device) and gather the
        per-detector metadata used for magnitudes/offsets (the reference's
        _loadMPSubSpace, detect.py:319-388).
        """
        Nc = len(channels)
        dataLength = self.dataLength
        det = {}
        for ind, row in DFsta.iterrows():
            events = list(row.Events)
            if self.issubspace:
                U = np.array([row.SVD[x] for x in row.UsedSVDKeys])
                if "Starttime" in row.SampleTrims:
                    s0 = row.SampleTrims["Starttime"]
                    s1 = row.SampleTrims["Endtime"]
                    WFs = np.array([row.AlignedTD[x][s0:s1] for x in events])
                else:
                    WFs = np.array([row.AlignedTD[x] for x in events])
            else:
                mptd = list(row.MPtd.values())[0]
                if row.SampleTrims:
                    s0 = row.SampleTrims["Starttime"]
                    s1 = row.SampleTrims["Endtime"]
                    upr = mptd[s0:s1]
                else:
                    upr = mptd
                U = np.array([upr / np.linalg.norm(upr)])
                WFs = np.array([upr])
            dlen = U.shape[1]
            mags = np.array([row.Stats[x]["magnitude"] for x in events])
            # WFU = WFs @ (U^T U), associated as (WFs @ U^T) @ U: same
            # math as the reference's UtU product (detect.py:367,381) at
            # O(E n D) instead of O(E n^2) FLOPs — and the [n, n] UtU
            # matrix (648 MB f64 at n=9000; a rank-1 outer product per
            # singleton) is never materialized. _estMag applies the same
            # association per trigger (PERF.md round 5 dense-gap fix).
            det[row.Name] = dict(
                U=U, WFs=WFs, n=dlen, mags=mags,
                events=events, offsets=row.Offsets,
                WFU=np.dot(np.dot(WFs, U.T), U))
        # group by template length into banks (demuxed fast path when the
        # template length divides into the channels)
        banks = []
        by_n = {}
        for name in sorted(det):
            by_n.setdefault(det[name]["n"], []).append(name)
        pad_len = int(dataLength * samplingRate * Nc)
        for n, names in sorted(by_n.items()):
            # pad detector rows / basis slots to the shared shape ladders
            # (ds.pad_rows / ds.pad_dims): one compiled scan program per
            # rung for the whole network instead of one per exact
            # (station, count) pair — with subspace.TRIM_QUANTUM keeping
            # by_n itself O(1), this bounds total XLA compiles
            # (SURVEY §7). Pad rows are zero templates (DS == 0) gated by
            # +inf thresholds. build_bank's size rule picks full-length
            # or overlap-save spectra.
            dmax = max(det[nm]["U"].shape[0] for nm in names)
            bank = _ds.build_bank([det[nm]["U"] for nm in names], Nc,
                                  pad_len, pad_S=_ds.pad_rows(len(names)),
                                  min_dmax=_ds.pad_dims(dmax))
            bank["names"] = names
            if self.devicePrep:
                if not bank.get("demux"):
                    detex_tpu.log(__name__, "devicePrep requires template "
                                  "lengths divisible by the channel count; "
                                  "falling back to host prep",
                                  level="warning", pri=True)
                    self.devicePrep = False
                else:
                    # samplingRate is the (possibly decimated) template
                    # rate; H acts on the raw chunk at raw rate over
                    # dec * nfftp bins. OS banks carry no full-length
                    # FFT size, so recompute it with the demux-bank
                    # formula (H is then bit-identical either way).
                    dec = self.dpDec
                    raw_sr = samplingRate * dec
                    if bank.get("os"):
                        nfftp = 2 ** int(
                            pad_len // Nc + bank["n_c"]).bit_length()
                    else:
                        nfftp = bank["nfft2"]
                    nbins = dec * nfftp
                    if self.filt is not None:
                        if self.filt[1] >= samplingRate / 2.0 and dec > 1:
                            detex_tpu.log(
                                __name__, "devicePrep decimation needs the "
                                "bandpass below the decimated Nyquist; "
                                "falling back to host prep",
                                level="warning", pri=True)
                            self.devicePrep = False
                            banks.append(bank)
                            continue
                        from detex_tpu.ops import prep as _prep
                        bank["H"] = _prep.butter_response(
                            self.filt, raw_sr, nbins,
                            zerophase=bool(self.filt[3]))
                    else:
                        import jax.numpy as jnp
                        bank["H"] = jnp.ones(nbins // 2 + 1, jnp.float32)
            banks.append(bank)
        return det, banks

    def _corDat(self, threshold, sta, channels, names, DFsta, samplingRate,
                stakey):
        """Stream chunks and detect (reference detect.py:137-218)."""
        numdets = 0
        tableName = "ss_df" if self.issubspace else "sg_df"
        DF = pd.DataFrame()
        histdic = {na: np.zeros(len(self.hist["Bins"]) - 1)
                   for na in names} if self.calcHist else None
        nc = len(channels)
        with _prof.stage("detect.prepare_banks"):
            det, banks = self._prepareDetectors(DFsta, sta, channels,
                                                samplingRate)
        if self.classifyEvents is not None:
            datGen = self.fetcher.getTemData(self.eveKey, stakey,
                                             returnName=False,
                                             returnTimes=True)
        else:
            datGen = self.fetcher.getConData(stakey, utcstart=self.utcStart,
                                             utcend=self.utcEnd,
                                             returnTimes=True)
        use_batch = (self.batchSize > 1 and self.classifyEvents is None
                     and self.utcSaves is None and self.trigCon == 0)
        if use_batch:
            return self._corDatBatched(threshold, sta, names, det, banks,
                                       nc, datGen, histdic, tableName)
        # trigger thresholds: trigCon=1 (STA/LTA of DS) uses its own
        # staltaThreshold parameter, not the per-row DS Threshold column
        trigth = self._trigThresholds(threshold)
        tail_trim = self._conTrimSamps(DFsta, nc, samplingRate)
        for st, utc1, utc2 in datGen:
            if st is None or len(st) < 1:
                detex_tpu.log(__name__, "could not get data on %s from %s to"
                              " %s" % (stakey.STATION.iloc[0], utc1, utc2),
                              level="warning", pri=True)
                continue
            result = self._scanChunk(st, det, banks, nc, sta, utc1, utc2,
                                     tail_trim=tail_trim)
            if result is None:
                continue
            dsdict, MPcon, sr, tstamp = result
            for name, dsvec in dsdict.items():
                if self.calcHist:
                    hg, _ = np.histogram(dsvec, bins=self.hist["Bins"])
                    histdic[name] = histdic[name] + hg
                maxds = float(dsvec.max()) if len(dsvec) else 0.0
                stalta_vec = None
                if not self.fillZeros and self.triggerLTATime:
                    try:
                        stalta_vec = np.asarray(self._dsStalta(
                            dsvec, self.triggerLTATime * sr,
                            self.triggerSTATime * sr))
                    except Exception:
                        detex_tpu.log(__name__, "failing to calculate "
                                      "sta/lta of det. statistic on %s for "
                                      "%s" % (sta, name), level="warning")
                if isinstance(self.utcSaves, np.ndarray):
                    self._makeUTCSaveDF(name, threshold, sta, det, MPcon,
                                        dsvec, sr, tstamp)
                if self.classifyEvents is not None:
                    self.eventCorList.append(pd.DataFrame(
                        [[sta, name, maxds, tstamp]],
                        columns=["Sta", "Name", "DS", "TimeStamp"]))
                if self.trigCon == 1:
                    trig_val = (float(np.nanmax(stalta_vec))
                                if stalta_vec is not None else 0.0)
                else:
                    trig_val = maxds
                if trig_val > trigth[name]:
                    Sar = self._createCoeffArray(
                        dsvec, stalta_vec, name, trigth, sta, det, MPcon,
                        nc, sr, tstamp)
                    if len(Sar) > 300:
                        detex_tpu.log(__name__, "over 300 events found in "
                                      "single data block on %s; perhaps "
                                      "minCoef is too low?" % sta,
                                      level="warning", pri=True)
                    if any(Sar.DS > 1.05):
                        detex_tpu.log(__name__, "DS values above 1.05 found"
                                      " on %s, removing" % sta,
                                      level="warning", pri=True)
                        Sar = Sar[Sar.DS <= 1.05]
                    if len(Sar) > 0:
                        DF = pd.concat([DF, Sar], ignore_index=True)
                    if len(DF) > 500:
                        _util.saveSQLite(DF, self.subspaceDB, tableName)
                        numdets += len(DF)
                        DF = pd.DataFrame()
        if len(DF) > 0:
            _util.saveSQLite(DF, self.subspaceDB, tableName)
        detType = "Subspaces" if self.issubspace else "Singletons"
        detex_tpu.log(__name__, "%s on %s completed, %d potential "
                      "detection(s) recorded"
                      % (detType, sta, len(DF) + numdets), pri=True)
        return histdic if self.calcHist else None

    def _corDatBatched(self, threshold, sta, names, det, banks, nc, datGen,
                       histdic, tableName):
        """
        Batched scan path: chunks are filtered/multiplexed on host, stacked
        ``batchSize`` at a time, and processed with the batched device scan
        (DS + histogram + maxima on device); only triggered chunks pull a
        full DS vector back for the exact-parity trigger/magnitude logic.

        Batches are DISPATCHED asynchronously and materialized one
        dispatch later (self._inflight): device dispatch returns
        immediately, so while the device computes batch k the host preps
        batch k+1 — or the next station's banks/data (the queue is drained
        by later stations and finally by __init__). Results are
        materialized strictly FIFO, so DB row order matches the serial
        formulation.
        """
        from detex_tpu.parallel import scan as _pscan
        pending = []  # (MPcon, sr, tstamp)
        # multi-device: shard the chunk batch across all local devices
        # (the station x detector x chunk grid's chunk axis; SURVEY.md
        # section 2 checklist). Histograms merge on device via psum; maxima
        # and the rare triggered chunks come back exactly as single-device.
        mesh = _pscan.engine_mesh()
        thresholds_by_bank = [
            np.asarray([threshold[nm] for nm in bank["names"]] +
                       [np.inf] * (int(bank["sum_u"].shape[0]) -
                                   len(bank["names"])), np.float32)
            for bank in banks]
        ctx = dict(sta=sta, DF=pd.DataFrame(), numdets=0, histdic=histdic,
                   tableName=tableName, det=det, threshold=threshold,
                   nc=nc, open_batches=0, station_done=False)

        def _pack_summary(hist, maxds):
            """Pack the per-batch summaries into ONE device array so the
            materialize step pays ONE blocking device->host round trip
            instead of two: int32 histogram
            bits ride as bitcast f32 (exact), maxds appended as-is."""
            import jax
            hb = jax.lax.bitcast_convert_type(
                hist.astype(jnp.int32), jnp.float32).ravel()
            return jnp.concatenate([hb, maxds.astype(jnp.float32).ravel()])

        def dispatch(batch):
            if not batch:
                return
            # keep the device batch shape constant (one compile): the
            # trailing partial batch is padded with empty chunks whose
            # valid length masks everything out
            B = self.batchSize
            outs = []
            for bank, th in zip(banks, thresholds_by_bank):
                pad = bank["pad_len"]
                bins = self.hist["Bins"] if self.calcHist else None
                if self.devicePrep:
                    Lp = (pad // nc) * self.dpDec
                    Xc = np.zeros((B, nc, Lp), np.float32)
                    lens = []
                    for bi, (payload, sr, tstamp) in enumerate(batch):
                        ch = payload["chans"]
                        L = min(ch.shape[1], Lp)
                        Xc[bi, :, :L] = ch[:, :L]
                        lens.append(L)
                    lens.extend([0] * (B - len(batch)))
                    with _prof.stage("detect.ds_scan_batched"):
                        # summary-only scan: the engine gates on maxima
                        # and re-verifies triggered chunks host-side, so
                        # device trigger lists are never produced
                        hist, maxds, *_ = _pscan.scan_chunks_raw(
                            Xc, lens, bank["H"], bank, th, nc,
                            buff_samps=1, bins=bins, max_trig=1,
                            dec=self.dpDec, mesh=mesh,
                            calc_hist=self.calcHist, calc_triggers=False)
                else:
                    X = np.zeros((B, pad), np.float32)
                    lens = []
                    for bi, (payload, sr, tstamp) in enumerate(batch):
                        MPcon = payload
                        L = min(len(MPcon), pad)
                        X[bi, :L] = MPcon[:L]
                        lens.append(L)
                    lens.extend([0] * (B - len(batch)))
                    # single-device: upload the batch ourselves and keep
                    # the device array alive until materialize — the
                    # device-windowed re-verify gathers its triggered
                    # chunks from it instead of re-uploading them (the
                    # sharded path places per-shard buffers itself and
                    # requires a host array)
                    Xin = (np.asarray(X) if mesh is not None
                           else jnp.asarray(X))
                    with _prof.stage("detect.ds_scan_batched"):
                        # summary-only scan (see devicePrep branch above)
                        hist, maxds, *_ = _pscan.scan_chunks(
                            Xin, bank, th, nc, buff_samps=1,
                            bins=bins, max_trig=1, valid_lens=lens,
                            mesh=mesh, calc_hist=self.calcHist,
                            calc_triggers=False)
                    if mesh is None and X.nbytes <= _keep_dev_batch_bytes():
                        outs.append((bank, hist, maxds,
                                     _pack_summary(hist, maxds), Xin,
                                     lens))
                        continue
                    if mesh is None and not ctx.get("keep_warned"):
                        ctx["keep_warned"] = True
                        detex_tpu.log(
                            __name__, "scan batch (%.0f MB) exceeds the "
                            "re-verify retention budget "
                            "(DETEX_TPU_REVERIFY_KEEP_MB); triggered "
                            "chunks will re-upload instead"
                            % (X.nbytes / 1e6), pri=True)
                packed = (_pack_summary(hist, maxds) if mesh is None
                          else None)
                outs.append((bank, hist, maxds, packed, None, None))
            ctx["open_batches"] += 1
            self._inflight.append((ctx, outs, list(batch)))
            while len(self._inflight) > self._inflight_depth:
                self._materializeOne()

        nmax = max(d["n"] for d in det.values())
        for st, utc1, utc2 in datGen:
            if st is None or len(st) < 1:
                detex_tpu.log(__name__, "could not get data on %s from %s "
                              "to %s" % (sta, utc1, utc2), level="warning",
                              pri=True)
                continue
            try:
                with _prof.stage("detect.filter"):
                    # devicePrep: merge/trim only on host; detrend, bandpass
                    # (and decimation) run fused on device
                    filt = None if self.devicePrep else self.filt
                    deci = None if self.devicePrep else self.decimate
                    conSt = _applyFilter(st, filt, deci, self.dtype,
                                         fillZeros=self.fillZeros)
            except Exception:
                detex_tpu.log(__name__, "failed to filter chunk on %s"
                              % sta, level="warning", pri=True)
                continue
            if len(conSt) < 1:
                continue
            sr = conSt[0].stats.sampling_rate
            if self.devicePrep:
                sr = sr / self.dpDec  # DS runs at the decimated rate
            tstamp = conSt[0].stats.starttime.timestamp
            if self.devicePrep:
                conSt.sort()
                L = min(len(tr.data) for tr in conSt)
                if (L // self.dpDec) * nc <= nmax:
                    continue
                chans = np.stack([np.asarray(tr.data[:L], np.float32)
                                  for tr in conSt])
                pending.append((dict(chans=chans, st=conSt), sr, tstamp))
            else:
                with _prof.stage("detect.multiplex"):
                    MPcon = multiplex(conSt, nc)
                if len(MPcon) <= nmax:
                    continue
                pending.append((MPcon, sr, tstamp))
            if len(pending) >= self.batchSize:
                dispatch(pending)
                pending = []
        dispatch(pending)
        ctx["station_done"] = True
        if ctx["open_batches"] == 0:
            self._finalizeStation(ctx)
        # remaining in-flight batches drain during the next station's prep
        # (or in __init__'s final drain); histdic is filled in place there
        return histdic if self.calcHist else None

    def _materializeOne(self):
        """Materialize the oldest in-flight device batch: gate on maxima,
        re-verify triggered chunks through the exact host path, accumulate
        histograms, and flush detections (FIFO — DB row order matches the
        serial formulation)."""
        with _prof.stage("detect.materialize"):
            self._materializeOneInner()

    def _materializeOneInner(self):
        ctx, outs, batch = self._inflight.popleft()
        sta = ctx["sta"]
        det = ctx["det"]
        threshold = ctx["threshold"]
        nc = ctx["nc"]
        histdic = ctx["histdic"]
        # gate margins: triggered chunks are re-verified host-side, so
        # gating a touch below threshold only costs a recompute.
        # devicePrep -> spectral-vs-SOS filter discrepancy;
        # dtype='double' -> f32 device scan vs f64 exact recompute.
        gate_eps = self.devicePrepEps if self.devicePrep else 0.0
        if self.dtype == "double":
            gate_eps = max(gate_eps, 1e-4)
        else:
            # f32 drift envelope between the batched device scan and the
            # per-chunk recompute (measured ~2e-5 over million-sample
            # chunks; tests/test_parity_oracle.py): without this margin an
            # f32 maxds a hair below threshold silently drops a detection
            # the exact path would emit
            gate_eps = max(gate_eps, 2e-5)
        for bank, hist_dev, maxds_dev, packed_dev, Xd, xlens in outs:
            if packed_dev is not None:
                # single blocking transfer for both summaries (see
                # _pack_summary): unpack by the device arrays' shapes
                S_, nbin_ = hist_dev.shape
                packed = np.asarray(packed_dev)
                hist = packed[:S_ * nbin_].view(np.int32).reshape(S_,
                                                                  nbin_)
                maxds = packed[S_ * nbin_:].reshape(maxds_dev.shape)
            else:
                hist = np.asarray(hist_dev)  # blocks until device done
                maxds = np.asarray(maxds_dev)
            # gate first: the batch's triggered detectors are re-verified
            # with ONE bank program over all triggered chunks (row-sized
            # transfers only) — instead of k full [S, L] bank launches,
            # each copying the whole DS array to host, for a dense batch
            # where k of S templates trigger
            trig_bis, trig_rows, mpcons = [], [], []
            for bi, (payload, sr, tstamp) in enumerate(batch):
                trig = [si for si, name in enumerate(bank["names"])
                        if maxds[bi, si] > threshold[name] - gate_eps]
                if not trig:
                    continue
                if self.devicePrep:
                    # exact-parity host filter, triggered only
                    stf = _applyFilter(
                        payload["st"].copy(), self.filt,
                        self.decimate, self.dtype,
                        fillZeros=self.fillZeros)
                    MPcon = multiplex(stf, nc)
                else:
                    MPcon = payload
                trig_bis.append(bi)
                trig_rows.append(trig)
                mpcons.append(MPcon)
            use_sl = bool(not self.fillZeros and self.triggerLTATime)
            use_dev_trig = (self.dtype != "double" and len(trig_bis) > 0
                            and os.environ.get("DETEX_TPU_DEVICE_TRIGGERS",
                                               "1") != "0")
            if len(trig_bis) > 0:
                # observable next to the scan route
                from detex_tpu.parallel.scan import _note_route
                _note_route("dense-reverify-device" if use_dev_trig
                            else "dense-reverify-host")
            if use_dev_trig:
                # device-windowed re-verify: DS STA/LTA + the exact
                # trigger extraction run inside the bank's device
                # program; only per-trigger indices/values are copied to
                # host. The host chain below moves each triggered row
                # through three full ~MB round trips (download row,
                # upload for the STA/LTA kernel + download, upload again
                # for extract_triggers).
                thr_list = [[float(threshold[bank["names"][si]])
                             for si in trig] for trig in trig_rows]
                srs = [batch[bi][1] for bi in trig_bis]
                if Xd is not None:
                    # gather the triggered chunks from the batch the
                    # scan already uploaded — no host re-upload (the
                    # packed rows are bit-identical to re-packing the
                    # mpcons payloads; devicePrep keeps Xd=None since
                    # its exact re-verify data is host-filtered).
                    # Gather at a power-of-two row count so every
                    # trigger multiplicity shares one compiled take
                    # (pad slots repeat row 0, masked by zero lens)
                    Nsel = len(trig_bis)
                    Bp = 1 << max(Nsel - 1, 0).bit_length()
                    sel = trig_bis + [trig_bis[0]] * (Bp - Nsel)
                    x_dev = jnp.take(Xd, jnp.asarray(sel, jnp.int32),
                                     axis=0)
                    lens_dev = [xlens[bi] for bi in trig_bis] + \
                        [0] * (Bp - Nsel)
                else:
                    x_dev = lens_dev = None
                trig_out = _ds.run_bank_triggers_batch(
                    mpcons, bank, nc, trig_rows, thr_list, srs,
                    self.triggerLTATime or 0.0,
                    self.triggerSTATime or 0.0, use_sl, MAX_TRIGGERS,
                    x_dev=x_dev, lens_dev=lens_dev)
            else:
                trig_out = None
                if self.dtype == "double":
                    dsrows_of = [
                        {si: _ds.ds_numpy(np.asarray(mp, np.float64),
                                          det[bank["names"][si]]["U"], nc)
                         for si in trig}
                        for mp, trig in zip(mpcons, trig_rows)]
                else:
                    dsrows_of = _ds.run_bank_rows_batch(mpcons, bank, nc,
                                                        trig_rows)
            bank_rows = []  # row lists; ONE DataFrame per bank per batch
            for zi, (bi, trig, MPcon) in enumerate(
                    zip(trig_bis, trig_rows, mpcons)):
                payload, sr, tstamp = batch[bi]
                for si in trig:
                    name = bank["names"][si]
                    if trig_out is not None:
                        idx, ds_at, sl_at = trig_out[zi][si]
                        if len(idx) >= MAX_TRIGGERS:
                            detex_tpu.log(
                                __name__, "over %d events found in "
                                "single data block on %s for %s"
                                % (MAX_TRIGGERS, sta, name),
                                level="error")
                        rl = self._coeffRowList(idx, ds_at, sl_at, name,
                                                sta, det, MPcon, nc, sr,
                                                tstamp)
                        if len(rl) > 300:
                            detex_tpu.log(
                                __name__, "over 300 events found in "
                                "single data block on %s; perhaps "
                                "minCoef is too low?" % sta,
                                level="warning", pri=True)
                        if any(r[0] > 1.05 for r in rl):
                            detex_tpu.log(
                                __name__, "DS values above 1.05 found "
                                "on %s, removing" % sta,
                                level="warning", pri=True)
                            rl = [r for r in rl if r[0] <= 1.05]
                        bank_rows.extend(rl)
                        continue
                    else:
                        # exact-parity slow path for the triggered chunk
                        dsvec = dsrows_of[zi][si]
                        if dsvec.max() > 1.1:
                            dsvec = np.where(np.isfinite(dsvec), dsvec,
                                             0.0)
                        stalta_vec = None
                        if use_sl:
                            stalta_vec = np.asarray(self._dsStalta(
                                dsvec, self.triggerLTATime * sr,
                                self.triggerSTATime * sr))
                        Sar = self._createCoeffArray(
                            dsvec, stalta_vec, name, threshold, sta, det,
                            MPcon, nc, sr, tstamp)
                    if len(Sar) > 300:
                        detex_tpu.log(__name__, "over 300 events found "
                                      "in single data block on %s; "
                                      "perhaps minCoef is too low?"
                                      % sta, level="warning", pri=True)
                    if any(Sar.DS > 1.05):
                        detex_tpu.log(__name__, "DS values above 1.05 "
                                      "found on %s, removing" % sta,
                                      level="warning", pri=True)
                        Sar = Sar[Sar.DS <= 1.05]
                    if len(Sar) > 0:
                        ctx["DF"] = pd.concat([ctx["DF"], Sar],
                                              ignore_index=True)
            if bank_rows:
                ctx["DF"] = pd.concat(
                    [ctx["DF"], pd.DataFrame(bank_rows,
                                             columns=SAR_COLS)],
                    ignore_index=True)
            if self.calcHist:
                for si, name in enumerate(bank["names"]):
                    histdic[name] = histdic[name] + hist[si]
        if len(ctx["DF"]) > 500:
            _util.saveSQLite(ctx["DF"], self.subspaceDB, ctx["tableName"])
            ctx["numdets"] += len(ctx["DF"])
            ctx["DF"] = pd.DataFrame()
        ctx["open_batches"] -= 1
        if ctx["station_done"] and ctx["open_batches"] == 0:
            self._finalizeStation(ctx)

    def _finalizeStation(self, ctx):
        """Final DB flush + completion log for one station (runs once all
        of its in-flight batches have materialized)."""
        if len(ctx["DF"]) > 0:
            _util.saveSQLite(ctx["DF"], self.subspaceDB, ctx["tableName"])
        detType = "Subspaces" if self.issubspace else "Singletons"
        detex_tpu.log(__name__, "%s on %s completed, %d potential "
                      "detection(s) recorded"
                      % (detType, ctx["sta"],
                         len(ctx["DF"]) + ctx["numdets"]), pri=True)
        ctx["DF"] = pd.DataFrame()

    def _drainInflight(self):
        while getattr(self, "_inflight", None):
            self._materializeOne()

    def _conTrimSamps(self, DFsta, nc, sr):
        """
        Classify-mode tail trim in multiplexed samples (capability of
        reference _getConTrims, detect.py:580-597): each event chunk is cut
        by ``median(template_duration) - conBuff`` seconds (when positive)
        so energy in the trailing buffer region beyond the template span is
        not classified. The reference computed the same per-detector
        quantity but its trim slice was an arithmetic no-op (a negative
        ctrim *extends* the slice bound); detex_tpu applies the intended
        trim. Continuous mode never trims — association dedup handles
        chunk-overlap double counting (results.py).
        """
        if self.classifyEvents is None:
            return 0
        ctrims = []
        for _, row in DFsta.iterrows():
            trims = row.SampleTrims
            if "Starttime" in trims and "Endtime" in trims:
                dur = (trims["Endtime"] - trims["Starttime"]) / (sr * nc)
            else:
                wfs = row.AlignedTD if isinstance(
                    getattr(row, "AlignedTD", None), dict) else row.MPtd
                dur = min(len(w) for w in wfs.values()) / (sr * nc)
            ctrims.append(self.fetcher.conBuff - dur)
        ctrim = float(np.median(ctrims)) if ctrims else 0.0
        return int(-ctrim * sr * nc) if ctrim < 0 else 0

    def _scanChunk(self, st, det, banks, nc, sta, utc1, utc2, tail_trim=0):
        """Filter, multiplex and run all detector banks on one chunk
        (the reference's _getRA, detect.py:220-296)."""
        try:
            with _prof.stage("detect.filter"):
                conSt = _applyFilter(st, self.filt, self.decimate,
                                     self.dtype, fillZeros=self.fillZeros)
        except Exception:
            detex_tpu.log(__name__, "failed to filter chunk on %s, skipping"
                          % sta, level="warning", pri=True)
            return None
        if len(conSt) < 1:
            return None
        sr = conSt[0].stats.sampling_rate
        with _prof.stage("detect.multiplex"):
            MPcon = multiplex(conSt, nc)
        if tail_trim > 0:
            MPcon = MPcon[: max(len(MPcon) - int(tail_trim), 0)]
        tstamp = conSt[0].stats.starttime.timestamp
        if len(MPcon) <= max(d["n"] for d in det.values()):
            detex_tpu.log(__name__, "data block on %s from %s to %s is too "
                          "short, skipping" % (sta, utc1, utc2),
                          level="warning")
            return None
        dsdict = {}
        if self.dtype == "double":
            # exact float64 path (reference numerics end to end)
            x64 = np.asarray(MPcon, np.float64)
            with _prof.stage("detect.ds_scan"):
                vec_of = {name: _ds.ds_numpy(x64, det[name]["U"], nc)
                          for name in det}
        else:
            vec_of = {}
            for bank in banks:
                with _prof.stage("detect.ds_scan"):
                    ds = _ds.run_bank(MPcon, bank, nc)
                for i, name in enumerate(bank["names"]):
                    vec_of[name] = ds[i]
        for name, vec in vec_of.items():
            if len(vec) < 10:
                detex_tpu.log(__name__, "data block on %s too short, "
                              "skipping" % sta, level="warning")
                return None
            if vec.max() > 1.1:  # zero infs (reference detect.py:277-281)
                vec = np.where(np.isfinite(vec), vec, 0.0)
            dsdict[name] = vec
        return dsdict, MPcon, sr, tstamp

    def _dsStalta(self, dsvec, lta_samps, sta_samps):
        """STA/LTA of the DS: device kernel for f32, host float64 twin on
        the dtype='double' exact path."""
        if self.dtype == "double":
            return _stalta.ds_stalta_np(dsvec, lta_samps, sta_samps)
        return _stalta.ds_stalta(dsvec, lta_samps, sta_samps)

    def _trigThresholds(self, threshold):
        """Per-detector *trigger* thresholds: the DS Threshold column for
        trigCon=0; the user's staltaThreshold (float or dict keyed by
        detector name) for trigCon=1."""
        if self.trigCon != 1:
            return threshold
        st = self.staltaThreshold
        if isinstance(st, dict):
            missing = sorted(set(threshold) - set(st))
            if missing:
                detex_tpu.log(__name__, "staltaThreshold dict is missing "
                              "detectors: %s" % ", ".join(missing),
                              level="error")
            return {n: float(st[n]) for n in threshold}
        return {n: float(st) for n in threshold}

    def _makeUTCSaveDF(self, name, threshold, sta, det, MPcon, dsvec, sr,
                       tstamp):
        """Dump DS vectors covering requested times
        (reference detect.py:298-316)."""
        TS1 = tstamp
        TS2 = tstamp + len(dsvec) / sr
        inUTCs = (self.utcSaves > TS1) & (self.utcSaves < TS2)
        if np.any(inUTCs):
            dat = [sta, name, threshold[name], det[name]["offsets"], TS1,
                   TS2, self.utcSaves[inUTCs], MPcon, dsvec]
            inds = ["Station", "Name", "Threshold", "offset", "TS1", "TS2",
                    "utcSaves", "MPcon", "SSdetect"]
            self.UTCSaveList.append(pd.DataFrame([dat], columns=inds))

    def _createCoeffArray(self, dsvec, stalta_vec, name, threshold, sta, det,
                          MPcon, nc, sr, tstamp):
        """Extract triggers + magnitudes for one detector on one chunk
        (reference _CreateCoeffArray detect.py:390-445)."""
        cols = ["DS", "DS_STALTA", "STMP", "Name", "Sta", "MSTAMPmin",
                "MSTAMPmax", "Mag", "SNR", "ProEnMag"]
        if self.trigCon == 0:
            ceval = dsvec
        else:
            ceval = stalta_vec
        buff_samps = int(20 * sr)  # reference buff=20 s (detect.py:545)
        if self.dtype == "double":
            # float64 host extraction (no f32 cast of the DS vector)
            idx = _triggers.extract_triggers_np(
                ceval, float(threshold[name]), buff_samps,
                max_triggers=MAX_TRIGGERS)
            count = len(idx)
        else:
            idx, count = _triggers.extract_triggers(
                ceval, float(threshold[name]), buff_samps,
                max_triggers=MAX_TRIGGERS)
            idx = np.asarray(idx)[: int(count)]
        if int(count) >= MAX_TRIGGERS:
            detex_tpu.log(__name__, "over %d events found in single data "
                          "block on %s for %s" % (MAX_TRIGGERS, sta, name),
                          level="error")
        coefs = [float(dsvec[t]) for t in idx]
        if self.fillZeros or stalta_vec is None:
            slvals = None
        else:
            slvals = [float(stalta_vec[t]) for t in idx]
        return self._coeffRows(idx, coefs, slvals, name, sta, det, MPcon,
                               nc, sr, tstamp)

    def _coeffRows(self, idx, coefs, slvals, name, sta, det, MPcon, nc, sr,
                   tstamp):
        """Assemble the per-trigger detection rows (the tail of the
        reference's _CreateCoeffArray, detect.py:390-445) from trigger
        indices plus their DS / STA-LTA values — shared by the host
        extraction above and the device-windowed dense re-verify, which
        transfers only these per-trigger scalars."""
        return pd.DataFrame(
            self._coeffRowList(idx, coefs, slvals, name, sta, det, MPcon,
                               nc, sr, tstamp), columns=SAR_COLS)

    def _coeffRowList(self, idx, coefs, slvals, name, sta, det, MPcon, nc,
                      sr, tstamp):
        """Row-list twin of _coeffRows (columns = SAR_COLS): the dense
        materialize path accumulates these and builds ONE DataFrame per
        batch — a DataFrame + concat per (chunk, detector) pair was the
        dominant cost of detection-flood runs (pandas assembly measured
        ~79% of config-5's detex wall, PERF.md round 5)."""
        rows = []
        info = det[name]
        minof = np.min(info["offsets"])
        maxof = np.max(info["offsets"])
        for k, trigIndex in enumerate(idx):
            coef = float(coefs[k])
            times = float(trigIndex) / sr + tstamp
            SLValue = 0.0 if slvals is None else float(slvals[k])
            if self.estimateMags:
                peMag, stMag, SNR = self._estMag(int(trigIndex), info, MPcon,
                                                 nc, coef, times, name, sta)
            else:
                peMag, stMag, SNR = np.nan, np.nan, np.nan
            MSTAMPmax, MSTAMPmin = times - minof, times - maxof
            rows.append([coef, SLValue, times, name, sta, MSTAMPmin,
                         MSTAMPmax, stMag, SNR, peMag])
        return rows

    def _estMag(self, trigIndex, info, MPcon, nc, coef, times, name, sta):
        """Projected-energy and std-ratio magnitudes, CC^2-weighted
        (reference _estMag detect.py:447-499, Chambers et al. 2015)."""
        WFU = info["WFU"]
        U = info["U"]
        ewf = info["WFs"]
        mags = info["mags"]
        WFlen = WFU.shape[1]
        ConDat = MPcon[trigIndex * nc: trigIndex * nc + WFlen]
        if len(ConDat) < WFlen:
            return np.nan, np.nan, np.nan
        if self.issubspace:
            # (U^T U) @ ConDat associated as U^T @ (U @ ConDat): the
            # reference's projected energy (detect.py:460-462) at
            # O(n D) instead of O(n^2) per trigger — the dense path
            # runs this once per detection (PERF.md round 5)
            ssCon = U.T @ (U @ ConDat)
            proEn = np.var(ssCon) / np.var(WFU, axis=1)
        # pre-event noise level for SNR
        if trigIndex * nc > 5 * WFlen:
            pe = MPcon[trigIndex * nc - 5 * WFlen: trigIndex * nc]
        else:
            pe = MPcon[trigIndex * nc: trigIndex * nc + WFlen + 6 * WFlen]
        from detex_tpu import native as _native
        rollingstd = _native.rolling_std(pe, WFlen)
        baseNoise = np.median(rollingstd) if len(rollingstd) else np.nan
        SNR = np.std(ConDat) / baseNoise if baseNoise else np.nan
        touse = mags > -15
        if self.issubspace:
            if not np.any(touse):
                detex_tpu.log(__name__, "No magnitudes above -15 usable for "
                              "detection at %s on station %s and %s"
                              % (times, sta, name), level="warning")
                return np.nan, np.nan, SNR
            # host single-lag normalized correlation for BOTH dtypes: the
            # per-event dot products are ~1e4 MACs — a device call here is
            # pure round-trip overhead, and at dense detection rates (one
            # call per trigger) it dominated end-to-end runs. float64 on
            # the 'double' exact path, float32 otherwise (same math as
            # ops/xcorr.normcorr_bank).
            ftype = np.float64 if self.dtype == "double" else np.float32
            W = np.asarray(ewf, ftype)
            cd = np.asarray(ConDat, ftype)
            wflen = W.shape[1]
            NT = (W - W.mean(axis=1, keepdims=True)) / \
                (W.std(axis=1, keepdims=True) * wflen)
            eventCors = (NT @ cd - NT.sum(axis=1) * cd.mean()) \
                / cd.std()
            peMag = _estPEMag(mags, proEn, eventCors, touse)
            stMag = _estSTDMag(mags, ConDat, ewf, eventCors, touse)
        else:
            assert len(mags) == 1
            if np.isnan(mags[0]) or mags[0] < -15:
                return np.nan, np.nan, SNR
            d1 = np.dot(ConDat, WFU[0])
            d2 = np.dot(WFU[0], WFU[0])
            peMag = mags[0] + d1 / d2
            stMag = mags[0] + np.log10(np.std(ConDat) / np.std(WFU[0]))
        return peMag, stMag, SNR


def _np_rolling_std(x, n):
    """Trailing rolling sample std (pandas ddof=1 semantics), length
    len(x)-n+1."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) < n:
        return np.array([])
    c = np.cumsum(np.insert(x, 0, 0.0))
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    s = c[n:] - c[:-n]
    s2 = c2[n:] - c2[:-n]
    var = np.maximum((s2 - s * s / n) / (n - 1), 0.0)
    return np.sqrt(var)


def _getChannels(df):
    """Common channel list of a detector DataFrame
    (reference detect.py:600-616)."""
    row = df.iloc[0] if isinstance(df, pd.DataFrame) else df
    chan_lists = list(row.Channels.values())
    chans = set(x for lst in chan_lists for x in lst)
    if not all(chans == set(x) for x in row.Channels.values()):
        detex_tpu.log(__name__, "Not all channels are the same for each "
                      "event on %s, skipping" % row.Station, level="warning",
                      pri=True)
        return None
    return sorted(chans)


def _getSampleRates(df):
    """Common sampling rate (reference detect.py:619-634)."""
    row = df.iloc[0] if isinstance(df, pd.DataFrame) else df
    srs = set(row.Stats[x]["sampling_rate"] for x in row.Events)
    if len(srs) > 1:
        detex_tpu.log(__name__, "Not all sample rates equal on %s, skipping"
                      % row.Station, level="warning", pri=True)
        return None
    return sorted(srs)


def _estPEMag(mags, proEn, eventCors, touse):
    """CC^2-weighted projected-energy magnitude, Chambers et al. 2015
    (capability of reference detect.py:637-649; vectorized): each training
    event estimates mag_i + log10(sqrt(proEn_i)); estimates are averaged
    with squared-correlation weights over the usable (mag > -15) events."""
    w = np.square(np.asarray(eventCors))[touse]
    est = np.asarray(mags)[touse] + np.log10(np.sqrt(
        np.asarray(proEn)[touse]))
    return float(np.sum(est * w) / np.sum(w))


def _estSTDMag(mags, ConDat, ewf, eventCors, touse):
    """CC^2-weighted std-ratio magnitude (capability of reference
    detect.py:652-664; vectorized like _estPEMag)."""
    w = np.square(np.asarray(eventCors))[touse]
    ratio = np.std(ConDat) / np.std(np.asarray(ewf), axis=1)[touse]
    est = np.asarray(mags)[touse] + np.log10(ratio)
    return float(np.sum(est * w) / np.sum(w))
