"""
Model/state containers: ClusterStream, Cluster (clustering state) and
SubSpace (subspace detectors) — reference detex/subspace.py rebuilt.

SVD runs on device (detex_tpu.ops.svd); thresholds come from the empirical
null via detex_tpu.fas (beta fit on host scipy); detection dispatches to the
device engine in detex_tpu.detect.
"""
from __future__ import annotations

import json
import numbers
import os
import pickle
from functools import partial

import numpy as np
import pandas as pd
import scipy.stats
from scipy.cluster.hierarchy import fcluster

import detex_tpu
from detex_tpu import util as _util
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.ops import svd as _svd
from detex_tpu.ops import xcorr as _xcorr

# ---------------------------------------------------------------------------
# Template-length bucketing. The detection engine and the FAS null scanner
# pack detectors into fixed-shape device banks GROUPED BY template length
# (detect._prepareDetectors / fas._initFAS "by_n"), and every distinct
# length compiles a separate XLA program. Pick-derived trims naturally
# differ by a few samples per detector (per-event pick medians + channel
# snapping), which turns a network run into hundreds of compiles
# (SURVEY §7 "keep XLA compile counts bounded"). Rounding every trim
# window UP to a multiple of TRIM_QUANTUM per-channel samples (~1-3 s of
# extra real waveform at typical 25-100 Hz rates) collapses the length
# ladder to O(1) rungs.
# DETEX_TPU_TRIM_QUANTUM=1 disables (exact pick-span template lengths).
# ---------------------------------------------------------------------------
TRIM_QUANTUM = int(os.environ.get("DETEX_TPU_TRIM_QUANTUM", "64"))


def _quantize_trims(d1, Nc, max_len=None):
    """Round a SampleTrims window length up to a multiple of
    TRIM_QUANTUM * Nc multiplexed samples, in place. The window is
    extended forward into the aligned data; when that runs past
    ``max_len`` (the shortest event waveform) the start shifts earlier
    instead, and when the quantized window cannot fit at all the length
    is rounded DOWN (or left unchanged below one quantum). Starttime
    stays channel-aligned and non-negative."""
    q = TRIM_QUANTUM * int(Nc)
    if q <= int(Nc) or "Starttime" not in d1 or "Endtime" not in d1:
        return d1
    s0, s1 = int(d1["Starttime"]), int(d1["Endtime"])
    ln = s1 - s0
    if ln <= 0:
        return d1
    lnq = -(-ln // q) * q
    if max_len is not None and s0 + lnq > int(max_len):
        s0n = int(max_len) - lnq
        s0n -= s0n % int(Nc)      # floor keeps s0n + lnq <= max_len
        if s0n >= 0:
            s0 = s0n
        elif ln // q > 0:         # cannot fit: shrink to the lower rung
            lnq = (ln // q) * q
        else:
            return d1
    d1["Starttime"], d1["Endtime"] = s0, s0 + lnq
    return d1


class ClusterStream(object):
    """
    Container for per-station Cluster objects; created by
    detex_tpu.construct.createCluster (reference subspace.py:46-287).
    """

    def __init__(self, trdf, temkey, stakey, fetcher, eventList, ccReq, filt,
                 decimate, trim, fileName, eventsOnAllStations,
                 enforceOrigin):
        self.trdf = trdf
        self.temkey = temkey
        self.stakey = stakey
        self.fetcher = fetcher
        self.eventList = eventList
        self.ccReq = None  # can vary between stations
        self.filt = filt
        self.decimate = decimate
        self.trim = trim
        self.filename = fileName
        self.eventsOnAllStations = eventsOnAllStations
        self.enforceOrigin = enforceOrigin
        self.stalist = trdf.Station.values.tolist()
        self.stalist2 = [x.split(".")[1] for x in self.stalist]
        self.clusters = []
        for num, row in trdf.iterrows():
            evlist = row.Events if not eventsOnAllStations else eventList
            self.clusters.append(Cluster(self, row.Station, temkey, evlist,
                                         row.Link, ccReq, filt, decimate,
                                         trim, row.CCs))

    # -- hypoDD -----------------------------------------------------------
    def writeSimpleHypoDDInput(self, fileName="dt.cc", coef=1, minCC=.35):
        """
        Write a hypoDD cross-correlation (dt.cc) file from the pairwise lag
        matrices (reference subspace.py:70-155). Requires enforceOrigin=True
        at cluster creation.
        """
        if not self.enforceOrigin:
            detex_tpu.log(__name__, "Sample lags are not meaningful unless "
                          "origin times are enforced; re-run createCluster "
                          "with enforceOrigin=True", level="error")
        reqZeros = int(np.ceil(np.log10(max(len(self.temkey), 2))))
        fmt = "{:0%dd}" % reqZeros
        temnum = {name: num for num, name in
                  zip(self.temkey.index, self.temkey.NAME)}
        # one pass per station over its upper-triangle CC/lag matrices
        # (the reference re-scanned every station for every template pair,
        # O(T^2 * S); this is O(S * m^2) array work + the kept pairs)
        from detex_tpu.construct import _square_from_df
        obs = {}  # (num1, num2) -> [line, ...] in stalist order
        for sta in self.stalist:
            key = list(self[sta].key)
            trdf = self.trdf[self.trdf.Station == sta].iloc[0]
            m = len(key)
            cc = np.asarray(_square_from_df(trdf.CCs, m))
            lag = np.asarray(_square_from_df(trdf.Lags, m, fill=0.0))
            sub = np.asarray(_square_from_df(trdf.Subsamp, m, fill=0.0))
            sr = trdf.Stats[key[0]]["sampling_rate"]
            Nc = trdf.Stats[key[0]]["Nc"]
            iu, ju = np.triu_indices(m, k=1)
            vals = cc[iu, ju]
            good = np.isfinite(vals) & (vals >= minCC)
            secs = lag[iu, ju] / (sr * Nc) + sub[iu, ju]
            for i, j, c, lg in zip(iu[good], ju[good], vals[good],
                                   secs[good]):
                ni = temnum.get(key[i])
                nj = temnum.get(key[j])
                if ni is None or nj is None:
                    continue
                # matrix orientation is key[i] -> key[j]; flip the lag when
                # the global template order disagrees
                pair, lg = ((ni, nj), lg) if ni < nj else ((nj, ni), -lg)
                obs.setdefault(pair, []).append(
                    "%s %0.4f %0.4f S" % (sta, lg, c ** coef))
        lines = []
        for (n1, n2) in sorted(obs):
            lines.append("# %s %s 0.0" % (fmt.format(n1), fmt.format(n2)))
            lines.extend(obs[(n1, n2)])
        with open(fileName, "w") as fil:
            fil.write("\n".join(lines) + ("\n" if lines else ""))

    def updateReqCC(self, reqCC):
        """Re-threshold clusters without recomputing correlations
        (reference subspace.py:174-201)."""
        if isinstance(reqCC, float):
            if reqCC < 0 or reqCC > 1:
                detex_tpu.log(__name__, "reqCC must be between 0 and 1",
                              level="error")
            for cl in self.clusters:
                cl.updateReqCC(reqCC)
        elif isinstance(reqCC, dict):
            for key, val in reqCC.items():
                self[key].updateReqCC(val)
        elif isinstance(reqCC, (list, tuple)):
            for num, ccr in enumerate(reqCC):
                self[num].updateReqCC(ccr)

    def printAtr(self):
        for cl in self.clusters:
            cl.printAtr()

    def dendro(self, **kwargs):
        for cl in self.clusters:
            cl.dendro(**kwargs)

    def simMatrix(self, groupClusts=False, savename=False, returnMat=False,
                  **kwargs):
        return [cl.simMatrix(groupClusts, savename, returnMat, **kwargs)
                for cl in self.clusters]

    def plotEvents(self, projection=None, plotSingles=True, **kwargs):
        for cl in self.clusters:
            cl.plotEvents(projection, plotSingles, **kwargs)

    def write(self):
        """Pickle this instance to self.filename
        (reference subspace.py:261-267)."""
        detex_tpu.log(__name__, "writing ClusterStream instance as %s"
                      % self.filename, pri=True)
        with open(self.filename, "wb") as fh:
            pickle.dump(self, fh)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.clusters[key]
        if isinstance(key, str):
            if len(key.split(".")) == 1:
                return self.clusters[self.stalist2.index(key)]
            if len(key.split(".")) == 2:
                return self.clusters[self.stalist.index(key)]
        detex_tpu.log(__name__, "indexer must be an int, sta, or net.sta; "
                      "got %s" % key, level="error")

    def __len__(self):
        return len(self.clusters)

    def __repr__(self):
        return "ClusterStream with %d stations" % len(self.stalist)


class Cluster(object):
    """Per-station clustering state (reference subspace.py:290-712)."""

    def __init__(self, clustStream, station, temkey, eventList, link, ccReq,
                 filt, decimate, trim, DFcc):
        self.link = link
        self.DFcc = DFcc
        self.station = station
        self.temkey = temkey
        self.key = list(eventList)
        self.trim = trim
        self.decimate = decimate
        self.nonClustColor = "0.6"
        self.updateReqCC(ccReq)

    def updateReqCC(self, newccReq):
        """
        Re-form clusters at a new required CC without re-correlating
        (capability of reference subspace.py:305-346).

        detex_tpu derivation: the flat clusters at dissimilarity
        ``1 - ccReq`` come straight from ``scipy.cluster.hierarchy.fcluster``
        on the stored linkage. Clusters are ordered by the height of their
        root merge, tallest first, so detector numbering matches the
        reference's subset-cover walk over the link table (which peeled
        clusters off in descending top-link order).
        """
        if newccReq < 0. or newccReq > 1.:
            detex_tpu.log(__name__, "Parameter ccReq must be between 0 and 1",
                          level="error")
        self.ccReq = newccReq
        height = 1. - newccReq
        labels = fcluster(self.link, height, criterion="distance")
        members = {}
        for leaf, lab in enumerate(labels):
            members.setdefault(int(lab), []).append(leaf)
        # root-merge height per flat cluster: linkage rows come in
        # non-decreasing height order, so the last sub-threshold merge seen
        # for a label is its root. Track one representative leaf per
        # internal node to map a merge row to its flat label.
        n_leaf = len(self.key)
        rep = {}
        root_height = {}
        for i, row in enumerate(np.asarray(self.link)):
            a = int(row[0])
            ra = rep[a] if a >= n_leaf else a
            rep[n_leaf + i] = ra
            if row[2] <= height:
                root_height[int(labels[ra])] = float(row[2])
        grouped = sorted(
            (lab for lab, mem in members.items() if len(mem) > 1),
            key=lambda lab: (-root_height[lab], members[lab][0]))
        if not grouped:
            detex_tpu.log(__name__, "No events cluster with corr coef = "
                          "%1.3f" % self.ccReq, pri=True)
        self.clusts = [[self.key[i] for i in members[lab]]
                       for lab in grouped]
        self.singles = sorted(self.key[mem[0]]
                              for mem in members.values() if len(mem) == 1)
        self.clustcount = sum(len(c) for c in self.clusts)
        detex_tpu.log(__name__, "ccReq for station %s updated to ccReq=%1.3f"
                      % (self.station, newccReq), pri=True)

    # -- plots ------------------------------------------------------------
    def dendro(self, hideEventLabels=True, show=True, saveName=False,
               **kwargs):
        """Dendrogram of the linkage (reference subspace.py:415-460)."""
        import matplotlib.pyplot as plt
        from scipy.cluster.hierarchy import dendrogram
        fig, ax = plt.subplots(figsize=(9, 5))
        labels = None if hideEventLabels else self.key
        dendrogram(self.link, color_threshold=1 - self.ccReq, labels=labels,
                   ax=ax, **kwargs)
        ax.set_ylabel("Dissimilarity (1 - CC)")
        ax.set_title("%s (ccReq=%.2f)" % (self.station, self.ccReq))
        if saveName:
            fig.savefig(saveName)
        if show:  # pragma: no cover - interactive
            plt.show()
        plt.close(fig)
        return fig

    def simMatrix(self, groupClusts=False, savename=False, returnMat=False,
                  show=False, **kwargs):
        """Similarity-matrix image (reference subspace.py:628-688)."""
        import matplotlib.pyplot as plt
        m = len(self.key)
        cc = np.asarray(detex_tpu.construct._square_from_df(self.DFcc, m))
        full = np.where(np.isnan(cc), 0.0, cc)
        full = full + full.T + np.eye(m)
        order = np.arange(m)
        if groupClusts:
            order = []
            for cl in self.clusts:
                order.extend([self.key.index(e) for e in cl])
            order.extend([self.key.index(e) for e in self.singles])
            order = np.asarray(order)
        mat = full[np.ix_(order, order)]
        fig, ax = plt.subplots()
        im = ax.imshow(mat, vmin=0, vmax=1, interpolation="nearest")
        fig.colorbar(im, ax=ax, label="correlation coefficient")
        ax.set_title(self.station)
        if savename:
            fig.savefig(savename)
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return mat if returnMat else None

    def plotEvents(self, projection=None, plotSingles=True, show=False,
                   **kwargs):
        """Scatter of event locations colored by cluster (map-projection-free
        replacement of the reference's basemap plot, subspace.py:462-626)."""
        import matplotlib.pyplot as plt
        tk = self.temkey.set_index("NAME")
        fig, ax = plt.subplots()
        for ci, cl in enumerate(self.clusts):
            evs = [e for e in cl if e in tk.index]
            ax.scatter([tk.loc[e].LON for e in evs],
                       [tk.loc[e].LAT for e in evs], label="clust %d" % ci)
        if plotSingles:
            evs = [e for e in self.singles if e in tk.index]
            ax.scatter([tk.loc[e].LON for e in evs],
                       [tk.loc[e].LAT for e in evs], c=self.nonClustColor,
                       label="singles")
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        ax.legend(fontsize=7)
        ax.set_title(self.station)
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return fig

    def printAtr(self):
        print("%s had %d events and %d clusters with ccReq=%.3f"
              % (self.station, len(self.key), len(self.clusts), self.ccReq))

    def write(self):
        detex_tpu.log(__name__, "writing cluster instance as clust.pkl",
                      pri=True)
        with open("clust.pkl", "wb") as fh:
            pickle.dump(self, fh)

    def __repr__(self):
        return ("Cluster(station=%s, %d events, %d clusters, %d singles)"
                % (self.station, len(self.key), len(self.clusts),
                   len(self.singles)))


class SubSpace(object):
    """
    Holds per-station subspace and singleton DataFrames; SVD + dimension
    selection; thresholds; picks; FAS; detection driver
    (reference subspace.py:715-2037).
    """

    def __init__(self, singlesDict, subSpaceDict, cl, dtype, Pf, cfetcher):
        self.cfetcher = cfetcher
        self.clusters = cl
        self.subspaces = subSpaceDict
        self.singles = singlesDict
        self.singletons = singlesDict
        self.dtype = dtype
        self.Pf = Pf
        self.ssStations = sorted(self.subspaces.keys())
        self.singStations = sorted(self.singles.keys())
        self.Stations = sorted(set(self.ssStations) | set(self.singStations))
        self._stakey2 = {x: x for x in self.ssStations}
        self._stakey1 = {x.split(".")[1]: x for x in self.ssStations}

    # ------------------------------------------------------------------
    def validateClusters(self):
        """Discard aligned/trimmed waveforms that no longer meet the
        cluster's required CC (reference subspace.py:738-773)."""
        detex_tpu.log(__name__, "Validating aligned (and trimmed) waveforms "
                      "in each cluster", pri=True)
        for sta in list(self.subspaces.keys()):
            subs = self.subspaces[sta]
            ccreq = self.clusters[sta].ccReq
            for clustNum, row in subs.iterrows():
                stKeys = row.SampleTrims.keys()
                if "Starttime" in stKeys and "Endtime" in stKeys:
                    start = row.SampleTrims["Starttime"]
                    stop = row.SampleTrims["Endtime"]
                else:
                    start, stop = 0, -1
                for ev1num, ev1 in enumerate(list(row.Events)[:-1]):
                    ccs = []
                    for ev2 in list(row.Events)[ev1num + 1:]:
                        t = row.AlignedTD[ev1][start: stop]
                        s = row.AlignedTD[ev2][start: stop]
                        ccs.append(float(np.max(_xcorr.normcorr(t, s))))
                    if len(ccs) > 0 and max(ccs) < ccreq:
                        detex_tpu.log(__name__, "%s fails validation check "
                                      "or is ill-aligned on station %s, "
                                      "removing" % (ev1, row.Station),
                                      pri=True)
                        self._removeEvent(sta, ev1, clustNum)

    def _removeEvent(self, sta, event, clustNum):
        srow = self.subspaces[sta].loc[clustNum]
        srow.Events.remove(event)
        srow.AlignedTD.pop(event, None)

    # ------------------------------------------------------------------
    def SVD(self, selectCriteria=2, selectValue=0.9, conDatNum=100,
            threshold=None, normalize=False, useSingles=True,
            validateWaveforms=True, backupThreshold=None, **kwargs):
        """
        SVD the aligned waveforms, select the dimension of representation,
        and set detection thresholds (reference subspace.py:786-912; see its
        docstring for the selectCriteria/selectValue options, which are
        preserved: 2 = fractional-energy dim selection + empirical null
        thresholds, 3 = fractional-energy thresholds, 4 = fixed basis count).
        """
        self._checkSelection(selectCriteria, selectValue, threshold)
        if validateWaveforms:
            self.validateClusters()
        for station in self.ssStations:
            for ind, row in self.subspaces[station].iterrows():
                keys = sorted(row.Events)
                arr, basisLength = self._trimGroups(ind, row, keys, station)
                if basisLength == 0:
                    detex_tpu.log(__name__, "subspace %d on %s is failing "
                                  "alignment and trimming, deleting it"
                                  % (ind, station), level="warning")
                    self._drop_subspace(station, ind)
                    continue
                U, svals = _svd.svd_basis(arr, normalize=normalize,
                                          dtype=self.dtype)
                svdDict = {float(sv): U[:, i] for i, sv in enumerate(svals)}
                self.subspaces[station].at[ind, "SVD"] = svdDict
                fracEnergy = self._getFracEnergy(ind, row, svdDict, U)
                usedBasis = self._getUsedBasis(ind, row, svdDict, fracEnergy,
                                               selectCriteria, selectValue)
                self.subspaces[station].at[ind, "FracEnergy"] = fracEnergy
                self.subspaces[station].at[ind, "UsedSVDKeys"] = usedBasis
                self.subspaces[station].at[ind, "SVDdefined"] = True
                self.subspaces[station].at[ind, "NumBasis"] = len(usedBasis)
        if len(self.ssStations) > 0:
            self._setThresholds(selectCriteria, selectValue, conDatNum,
                                threshold, backupThreshold, kwargs)
        if len(self.singStations) > 0 and useSingles:
            self.setSinglesThresholds(conDatNum=conDatNum,
                                      threshold=threshold,
                                      backupThreshold=backupThreshold,
                                      **kwargs)

    def _drop_subspace(self, station, ssnum):
        space = self.subspaces[station]
        self.subspaces[station] = space[space.index != int(ssnum)]

    def _trimGroups(self, ind, row, keys, station):
        """Aligned, (optionally pick-)trimmed, demeaned waveform array for
        the SVD (reference subspace.py:921-943)."""
        stkeys = row.SampleTrims.keys()
        aliTD = row.AlignedTD
        if "Starttime" in stkeys and "Endtime" in stkeys:
            stim = max(row.SampleTrims["Starttime"], 0)
            etim = row.SampleTrims["Endtime"]
            arr = np.vstack([aliTD[x][stim:etim] -
                             np.mean(aliTD[x][stim:etim]) for x in keys])
        else:
            detex_tpu.log(__name__, "No trim times for %s and station %s, "
                          "try running attachPickTimes"
                          % (row.Name, station), level="warning", pri=True)
            arr = np.vstack([aliTD[x] - np.mean(aliTD[x]) for x in keys])
        return arr, arr.shape[1]

    def _checkSelection(self, selectCriteria, selectValue, threshold):
        if selectCriteria == 1:
            if selectValue <= 0:
                detex_tpu.log(__name__, "selectCriteria 1 maximizes "
                              "detection probability at the instance Pf; "
                              "selectValue is the design total signal "
                              "energy-to-noise ratio and must be > 0",
                              level="error", e=ValueError)
        elif selectCriteria in [2, 3]:
            if selectValue > 1 or selectValue < 0:
                detex_tpu.log(__name__, "selectValue must be a float between "
                              "0 and 1 for selectCriteria %d"
                              % selectCriteria, level="error", e=ValueError)
        elif selectCriteria == 4:
            if selectValue < 0 or not isinstance(selectValue, int):
                detex_tpu.log(__name__, "selectValue must be an int >= 0 "
                              "when selectCriteria==4", level="error",
                              e=ValueError)
        else:
            detex_tpu.log(__name__, "selectCriteria of %s is not supported"
                          % selectCriteria, level="error")
        if threshold is not None:
            if not isinstance(threshold, numbers.Number) or threshold < 0:
                detex_tpu.log(__name__, "threshold must be None or a positive"
                              " float", level="error", e=ValueError)

    def _getFracEnergy(self, ind, row, svdDict, U):
        """Cumulative energy capture per dimension
        (reference subspace.py:968-997)."""
        fracDict = {}
        keys = list(row.Events)
        stkeys = row.SampleTrims.keys()
        wfs = []
        for key in keys:
            aliwf = row.AlignedTD[key]
            if "Starttime" in stkeys and "Endtime" in stkeys:
                aliwf = aliwf[row.SampleTrims["Starttime"]:
                              row.SampleTrims["Endtime"]]
            wfs.append(aliwf)
        cum = _svd.frac_energy(U, np.vstack(wfs), dtype=self.dtype)
        for i, key in enumerate(keys):
            fracDict[key] = cum[i]
        fracDict["Average"] = np.average(cum, axis=0)
        fracDict["Minimum"] = np.min(cum, axis=0)
        return fracDict

    def _getUsedBasis(self, ind, row, svdDict, cumFracEnergy, selectCriteria,
                      selectValue):
        """Select the singular-vector keys to use as detectors
        (reference subspace.py:999-1013). selectCriteria 1 — reserved but
        never implemented by the reference (subspace.py:802-807) — picks
        the dimension maximizing detection probability at the instance Pf
        via the doubly noncentral beta (detex_tpu.stats, Harris 2006 §9),
        with selectValue as the design signal energy-to-noise ratio."""
        keys = sorted(svdDict.keys(), reverse=True)
        if selectCriteria == 1:
            from detex_tpu import stats as _stats
            avg = np.array(cumFracEnergy["Average"], dtype=float)
            N = len(next(iter(svdDict.values())))
            ndim, pds = _stats.dim_of_max_pd(avg, N, self.Pf,
                                             float(selectValue))
            detex_tpu.log(__name__, "selectCriteria 1: %d dimension(s) "
                          "maximize P_D=%.4f at Pf=%.2e (design SNR %.1f)"
                          % (ndim, pds[ndim - 1], self.Pf, selectValue),
                          pri=True)
            return keys[:ndim]
        if selectCriteria in [2, 3]:
            avg = np.array(cumFracEnergy["Average"], dtype=float)
            avg[-1] = 1.00
            ndim = int(np.argmax(avg >= selectValue))
            return keys[:ndim]
        if selectCriteria == 4:
            return keys[:selectValue + 1]

    def _setThresholds(self, selectCriteria, selectValue, conDatNum,
                       threshold, backupThreshold, kwargs=None):
        """Thresholds per subspace (reference subspace.py:1015-1054).
        kwargs may carry thresholdDist='beta' (default) or 'norm' — the
        normal-null option of the reference's legacy matched-filter engine
        (extras/xcorr.py trigCon 2/3)."""
        kwargs = dict(kwargs or {})
        thresholdDist = kwargs.pop("thresholdDist", "beta")
        if threshold is not None and threshold > 0:
            for station in self.ssStations:
                for ind in self.subspaces[station].index:
                    self.subspaces[station].at[ind, "Threshold"] = threshold
            return
        if selectCriteria in [1, 2, 4]:
            self.getFAS(conDatNum, **kwargs)
            for station in self.ssStations:
                for ind, row in self.subspaces[station].iterrows():
                    if thresholdDist == "norm":
                        mu, sigma = row.FAS["normdist"]
                        self.subspaces[station].at[ind, "Threshold"] = \
                            float(scipy.stats.norm.isf(self.Pf, mu, sigma))
                        continue
                    beta_a, beta_b = row.FAS["betadist"][0:2]
                    th = scipy.stats.beta.isf(self.Pf, beta_a, beta_b, 0, 1)
                    if th > .9:
                        th, pft = self._approxThld(beta_a, beta_b, station,
                                                   row, self.Pf, 1000, 3,
                                                   backupThreshold)
                        detex_tpu.log(__name__, "beta.isf failed with pf=%e,"
                                      " approximated threshold to %f (Pf=%e)"
                                      " for station %s %s via grid search"
                                      % (self.Pf, th, pft, station,
                                         row.Name), level="warning")
                    self.subspaces[station].at[ind, "Threshold"] = th
        elif selectCriteria == 3:
            for station in self.ssStations:
                for ind, row in self.subspaces[station].iterrows():
                    th = row.FracEnergy["Minimum"][row.NumBasis] * selectValue
                    self.subspaces[station].at[ind, "Threshold"] = th

    def setSinglesThresholds(self, conDatNum=50, recalc=False, threshold=None,
                             backupThreshold=None, **kwargs):
        """Thresholds for singletons; singles without pick times are dropped
        (reference subspace.py:1056-1108)."""
        kwargs = dict(kwargs)
        thresholdDist = kwargs.pop("thresholdDist", "beta")
        for sta in self.singStations:
            sing = self.singles[sta]
            sing["Name"] = ["SG%d" % x for x in range(len(sing))]
            accepted = sing[[len(x.keys()) > 0 for x in sing.SampleTrims]]
            self.singles[sta] = accepted.reset_index(drop=True)
        if threshold is None:
            self.getFAS(conDatNum, useSingles=True, useSubSpaces=False,
                        recalc=recalc, **kwargs)
        for sta in self.singStations:
            for ind, row in self.singles[sta].iterrows():
                if len(row.SampleTrims.keys()) < 1:
                    continue
                if threshold:
                    th = threshold
                elif thresholdDist == "norm":
                    mu, sigma = row.FAS[0]["normdist"]
                    th = float(scipy.stats.norm.isf(self.Pf, mu, sigma))
                else:
                    beta_a, beta_b = row.FAS[0]["betadist"][0:2]
                    th = scipy.stats.beta.isf(self.Pf, beta_a, beta_b, 0, 1)
                    if th > .9:
                        th, pft = self._approxThld(beta_a, beta_b, sta, row,
                                                   self.Pf, 1000, 3,
                                                   backupThreshold)
                        detex_tpu.log(__name__, "beta.isf failed with "
                                      "pf=%e; approximated threshold to %f "
                                      "(realized Pf=%e) for station %s %s"
                                      % (self.Pf, th, pft, sta, row.Name),
                                      level="warning")
                self.singles[sta].at[ind, "Threshold"] = th

    def _approxThld(self, beta_a, beta_b, sta, row, target, numint=None,
                    numloops=None, backupThreshold=None):
        """
        Threshold when ``beta.isf`` misbehaves (scipy bug #4677 makes isf
        return ~1 for extreme tail probabilities; the reference worked
        around it with a 3-level grid search, subspace.py:1110-1140).

        detex_tpu solves sf(x) = Pf directly: log-survival bisection via
        ``beta.logsf`` — monotone, well-conditioned down to Pf ~ 1e-300.
        Falls back to ``backupThreshold`` (or raises) when the fitted null
        cannot reach the target false-alarm rate inside (0, 1).
        """
        logsf = partial(scipy.stats.beta.logsf, a=beta_a, b=beta_b)
        logt = np.log(target)
        lo, hi = 0.0, 1.0
        ok = np.isfinite(logsf(x=0.5)) and logsf(x=lo) > logt
        if ok:
            for _ in range(200):  # bisection to ~1e-60 interval width
                mid = 0.5 * (lo + hi)
                v = logsf(x=mid)
                if not np.isfinite(v) or v > logt:
                    lo = mid
                else:
                    hi = mid
                if hi - lo < 1e-12 * max(hi, 1e-12):
                    break
            th = 0.5 * (lo + hi)
            v = logsf(x=th)
            # accept only a genuine interior root (sf(th) within 2x of Pf);
            # a degenerate fit drives the bisection into the x=1 boundary
            if 0.0 < th < 1.0 and np.isfinite(v) and abs(v - logt) < 0.7:
                return th, float(np.exp(v))
        if backupThreshold is None:
            detex_tpu.log(__name__, "Threshold root-find failing for %s on "
                          "%s, set it manually or use a backupThreshold"
                          % (sta, row.Name), level="error", e=ValueError)
        detex_tpu.log(__name__, "Threshold root-find failing for %s on %s, "
                      "using backup %.2f" % (sta, row.Name, backupThreshold),
                      level="warning", pri=True)
        return backupThreshold, target

    # ------------------------------------------------------------------
    # Picks
    # ------------------------------------------------------------------
    def pickTimes(self, duration=30, traceLimit=15, repick=False,
                  subspaces=True, singles=True, pickerFactory=None):
        """
        Interactive trim picking (reference subspace.py:1328-1416): open
        each unpicked subspace/singleton group in the matplotlib picker
        (detex_tpu.streamPick — q/a/w/s pick P/Pend/S/Send at the cursor,
        'v' advances, escape aborts saving progress) and derive
        SampleTrims from the picked phases exactly like the reference —
        the earliest pick opens the window, ``duration`` (or the latest
        pick) closes it.

        ``pickerFactory`` injects a scripted picker for headless use:
        any callable ``stream -> obj`` exposing ``._picks`` and
        ``.KeepGoing``. File-based/automatic alternatives remain
        attachPickTimes(pksFile) and autoPickTimes().
        """
        if pickerFactory is None:
            from detex_tpu.streamPick import streamPick as pickerFactory
        if subspaces:
            if self._pickTimes(self.subspaces, duration, traceLimit,
                               pickerFactory, repick=repick) is False:
                return
        if singles:
            self._pickTimes(self.singles, duration, traceLimit,
                            pickerFactory, repick=repick)

    def _pickTimes(self, trdfDict, duration, traceLimit, pickerFactory,
                   repick=False):
        """GUI-picking loop over one group dict; False = user aborted."""
        for sta in trdfDict:
            df = trdfDict[sta]
            for ind, row in df.iterrows():
                if row.SampleTrims and not repick:
                    continue
                st = self._makeOpStream(ind, row, traceLimit)
                pks = pickerFactory(st)
                d1 = {b.phase_hint: b.time.timestamp
                      for b in pks._picks if b}
                if d1:
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    # picks are on the multiplexed synthetic traces
                    # (sr=1, starttime=0): timestamps ARE sample indices;
                    # snap the window open to a channel-aligned sample
                    fp = int(min(d1.values()))
                    d1["Starttime"] = fp - fp % Nc
                    stime = d1["Starttime"]
                    if duration:
                        d1["Endtime"] = stime + int(duration * Sr * Nc)
                        d1["DurationSeconds"] = duration
                    else:
                        etime = int(max(d1.values()))
                        d1["Endtime"] = etime
                        d1["DurationSeconds"] = (etime - stime) / (Sr * Nc)
                    wfs = (row.AlignedTD if "AlignedTD" in row and
                           isinstance(row.AlignedTD, dict) else row.MPtd)
                    _quantize_trims(d1, Nc,
                                    max_len=min(len(wfs[e]) for e in eves))
                    stime = d1["Starttime"]
                    df.at[ind, "SampleTrims"] = d1
                    stats = df.at[ind, "Stats"]
                    for event in eves:
                        stN = stats[event]["starttime"] + stime / (Nc * Sr)
                        stats[event]["starttime"] = stN
                        stats[event]["offset"] = (
                            stN - stats[event]["origintime"])
                if not pks.KeepGoing:
                    detex_tpu.log(__name__, "aborting picking, progress "
                                  "saved", level="info", pri=True)
                    return False
            self._updateOffsets()
        return True

    def _makeOpStream(self, ind, row, traceLimit):
        """Multiplexed group waveforms as a pickable stream: one trace per
        event (channel=event, sr=1 so pick timestamps are multiplexed
        sample indices — reference subspace.py:1418-1441)."""
        from detex_tpu.core.stream import Stream, Trace
        st = Stream()
        wfs = (row.AlignedTD if "AlignedTD" in row
               and isinstance(row.AlignedTD, dict) else row.MPtd)
        for key in row.Events[:traceLimit]:
            st += Trace(data=np.asarray(wfs[key]),
                        header=dict(channel=key,
                                    network=str(row.get("Name", "")),
                                    station=row.Station))
        return st

    def autoPickTimes(self, duration=30, staTime=0.5, ltaTime=5.0,
                      repick=False):
        """
        Automatic trim definition (detex_tpu extension): picks the group
        stack's STA/LTA onset as the start time and trims ``duration``
        seconds, writing SampleTrims exactly like attachPickTimes would.
        """
        from detex_tpu.ops.stalta import classic_sta_lta
        for trdfDict in (self.subspaces, self.singles):
            for sta in trdfDict:
                df = trdfDict[sta]
                for ind, row in df.iterrows():
                    if row.SampleTrims and not repick:
                        continue
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    if "AlignedTD" in row and isinstance(row.AlignedTD, dict):
                        wfs = [row.AlignedTD[e] for e in eves]
                    else:
                        wfs = [row.MPtd[e] for e in eves]
                    stack = np.mean(np.abs(np.vstack(
                        [w[: min(len(x) for x in wfs)] for w in wfs])),
                        axis=0)
                    cft = classic_sta_lta(stack, staTime * Sr * Nc,
                                          ltaTime * Sr * Nc)
                    onset = int(np.argmax(cft)) if cft.max() > 0 else 0
                    start = max(onset - int(0.5 * Sr * Nc), 0)
                    start -= start % Nc
                    end = start + int(duration * Sr * Nc)
                    end -= end % Nc
                    end = min(end, min(len(x) for x in wfs))
                    d1 = {"Starttime": int(start), "Endtime": int(end),
                          "DurationSeconds": duration}
                    _quantize_trims(d1, Nc,
                                    max_len=min(len(x) for x in wfs))
                    start = d1["Starttime"]
                    df.at[ind, "SampleTrims"] = d1
                    for event in eves:
                        stOld = df.at[ind, "Stats"][event]["starttime"]
                        stN = stOld + start / (Nc * Sr)
                        ot = df.at[ind, "Stats"][event]["origintime"]
                        df.at[ind, "Stats"][event]["starttime"] = stN
                        df.at[ind, "Stats"][event]["offset"] = stN - ot
        self._updateOffsets()

    def attachPickTimes(self, pksFile="PhasePicks.csv", function="median",
                        defaultDuration=30):
        """
        Attach pick times from a csv/pickle phase file (columns TimeStamp,
        Station, Event, Phase) and define SampleTrims
        (reference subspace.py:1461-1552).
        """
        try:
            pks = pd.read_csv(pksFile)
        except Exception:
            try:
                pks = pd.read_pickle(pksFile)
            except Exception:
                detex_tpu.log(__name__, "%s does not exist, or it is not a "
                              "pkl or csv file" % pksFile, level="error")
        funs = {"mean": np.mean, "max": np.max, "min": np.min,
                "median": np.median}
        if function not in funs:
            detex_tpu.log(__name__, "function %s not supported; options: "
                          "mean, median, min, max" % function, level="error")
        fun = funs[function]
        for cl in self.clusters.clusters:
            sta = cl.station
            for trdfDict in (self.singles, self.subspaces):
                if sta not in trdfDict:
                    continue
                for ind, row in trdfDict[sta].iterrows():
                    if len(row.SampleTrims.keys()) > 0:
                        continue
                    con1 = pks.Event.isin(row.Events)
                    con2 = pks.Station == sta
                    pk = pks[con1 & con2]
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    if len(pk) > 0:
                        trims = self._getSampTrim(eves, starttimes, Nc, Sr,
                                                  pk, defaultDuration, fun,
                                                  sta, ind, trdfDict[sta],
                                                  row)
                        if isinstance(trims, dict):
                            trdfDict[sta].at[ind, "SampleTrims"] = trims
                self._updateOffsets()

    def _getSampTrim(self, eves, starttimes, Nc, Sr, pk, defaultDuration,
                     fun, sta, num, DF, row):
        """
        Group sample trim from phase picks (capability of reference
        subspace.py:1554-1615): per event the earliest pick opens the
        window (clamped into the trace) and ``defaultDuration`` — or the
        pick span — closes it; the group trim is ``fun`` over the per-event
        windows, snapped down to a channel-aligned multiplexed sample.
        Aborts (None) if any pick falls beyond its trace.
        """
        samps_per_sec = Nc * Sr
        waveforms = getattr(row, "MPtd", None)
        if not isinstance(waveforms, dict):
            waveforms = row.AlignedTD
        first_pick = pk.groupby("Event").TimeStamp.min()
        last_pick = pk.groupby("Event").TimeStamp.max()
        stats = DF.at[num, "Stats"]
        windows = []  # (start_samp, stop_samp, duration_sec) per event
        for ev in eves:
            if ev not in first_pick.index:
                continue
            t_open = float(first_pick[ev])
            trace_t0 = starttimes[ev]
            open_samp = (t_open - trace_t0) * samps_per_sec
            wf = waveforms.get(ev)
            if wf is None:
                wf = row.AlignedTD[ev]
            if open_samp > len(wf):
                detex_tpu.log(__name__, "Start samples for %s on %s exceed "
                              "available data, skipping attaching pick"
                              % (ev, sta), level="warning")
                return None
            if open_samp < 0:
                detex_tpu.log(__name__, "Start time in phase file < 0 for "
                              "event %s" % ev, level="warning", pri=False)
                open_samp, t_open = 0.0, trace_t0
            t_close = (t_open + defaultDuration if defaultDuration
                       else float(last_pick[ev]))
            assert t_close > t_open and t_close > trace_t0
            windows.append((open_samp, (t_close - trace_t0) * samps_per_sec,
                            t_close - t_open))
            stats[ev]["Starttime"] = t_open
            stats[ev]["offset"] = t_open - stats[ev]["origintime"]
        if not windows:
            return None

        def snap(vals):  # channel-aligned multiplexed sample
            s = int(fun(vals))
            return s - s % Nc

        opens, closes, durations = zip(*windows)
        d1 = {"Starttime": snap(opens), "Endtime": snap(closes),
              "DurationSeconds": int(fun(durations))}
        wlens = [len(waveforms[ev]) for ev in eves if ev in waveforms]
        return _quantize_trims(d1, Nc,
                               max_len=min(wlens) if wlens else None)

    def _getStats(self, row):
        """Common sampling rate / channel count / per-event start times of
        an event group (capability of reference subspace.py:1617-1634)."""
        eves = list(row.Events)
        rates = {float(np.round(row.Stats[e]["sampling_rate"]))
                 for e in eves}
        if len(rates) != 1:
            detex_tpu.log(__name__, "Events on %s have different sampling "
                          "rates" % row.Station, level="error")
        chans = {row.Stats[e]["Nc"] for e in eves}
        if len(chans) != 1:
            detex_tpu.log(__name__, "Events on %s do not have the same "
                          "channels" % row.Station, level="error")
        starttimes = {e: row.Stats[e]["starttime"] for e in eves}
        return eves, starttimes, chans.pop(), rates.pop()

    def _updateOffsets(self):
        """Recompute robust per-detector offsets (capability of reference
        subspace.py:1443-1459)."""
        for trdfDict in (self.subspaces, self.singles):
            for sta in trdfDict:
                for num, row in trdfDict[sta].iterrows():
                    offs = np.array([s["offset"]
                                     for s in row.Stats.values()], float)
                    trdfDict[sta].at[num, "Offsets"] = self._getOffsets(offs)

    def _getOffsets(self, offsets, m=25.):
        """[min, median, max] of the offsets after dropping entries more
        than ``m`` median-absolute-deviations out (capability of reference
        subspace.py:1636-1650)."""
        if len(offsets) > 1:
            dev = np.abs(offsets - np.median(offsets))
            mad = np.median(dev)
            if mad:
                offsets = offsets[dev / mad < m]
        return [np.min(offsets), np.median(offsets), np.max(offsets)]

    # ------------------------------------------------------------------
    def getFAS(self, conDatNum, LTATime=5, STATime=0.5, staltalimit=8.0,
               useSubSpaces=True, useSingles=False, numBins=401,
               recalc=False, **kwargs):
        """Estimate the empirical null (false-alarm statistics) for each
        subspace/singleton (reference subspace.py:1652-1743)."""
        from detex_tpu import fas as _fas
        if useSubSpaces:
            self._updateOffsets()
            for sta in self.subspaces:
                fas1 = self.subspaces[sta]["FAS"].iloc[0] \
                    if len(self.subspaces[sta]) else None
                if isinstance(fas1, dict) and not recalc:
                    detex_tpu.log(__name__, "FAS for station %s already "
                                  "calculated; pass recalc=True to redo"
                                  % sta, pri=True)
                else:
                    res = _fas._initFAS(self.subspaces[sta], conDatNum,
                                        self.clusters, self.cfetcher,
                                        LTATime=LTATime, STATime=STATime,
                                        staltalimit=staltalimit,
                                        numBins=numBins, dtype=self.dtype)
                    for i, ind in enumerate(self.subspaces[sta].index):
                        self.subspaces[sta].at[ind, "FAS"] = res[i]
        if useSingles:
            for sta in self.singles:
                sg = self.singles[sta]
                # batch the station's singletons into ONE _initFAS call:
                # its per-station grouping then collects the (same,
                # deterministic) null chunks once and scans every
                # singleton with banked device calls — a per-row call
                # re-fetched/re-filtered the chunks and compiled a
                # fresh one-detector bank program per singleton, which
                # dominated the end-to-end build wall
                todo = [a for a, ind in enumerate(sg.index)
                        if not (isinstance(sg["FAS"].iloc[a], list)
                                and not recalc)
                        and len(sg["SampleTrims"].iloc[a]) >= 1]
                if not todo:
                    continue
                res = _fas._initFAS(
                    sg.iloc[todo], conDatNum,
                    self.clusters, self.cfetcher, LTATime=LTATime,
                    STATime=STATime, staltalimit=staltalimit,
                    numBins=numBins, dtype=self.dtype, issubspace=False)
                for k, a in enumerate(todo):
                    self.singles[sta].at[sg.index[a], "FAS"] = [res[k]]

    # ------------------------------------------------------------------
    def detex(self, utcStart=None, utcEnd=None, subspaceDB="SubSpace.db",
              trigCon=0, triggerLTATime=5, triggerSTATime=0,
              multiprocess=False, delOldCorrs=True, calcHist=True,
              useSubSpaces=True, useSingles=False, estimateMags=True,
              classifyEvents=None, eventCorFile="EventCors", utcSaves=None,
              fillZeros=False, batchSize=32, devicePrep=False,
              staltaThreshold=None):
        """
        Run subspace detection over continuous data; detections land in the
        SQLite database ``subspaceDB`` with the reference schema
        (reference subspace.py:1745-1902). ``batchSize`` chunks are scanned
        per device call (histograms/maxima stay on device); 1 reverts to
        the per-chunk path (always used for classifyEvents/utcSaves modes).
        ``devicePrep=True`` fuses detrend + zero-phase bandpass into the
        device scan (see detex_tpu.ops.prep), removing the host filter from
        the hot path; triggered chunks are re-verified through the exact
        host-filtered path. With more than one device the engine shards
        its chunk batches over the mesh automatically (DETEX_TPU_MESH=0
        disables). trigCon=1 (STA/LTA of the DS, a detex_tpu extension)
        triggers on ``staltaThreshold`` — a float, or a {detector-name:
        float} dict — NOT on the per-row DS Threshold column.
        """
        from detex_tpu.detect import _SSDetex
        if multiprocess:
            detex_tpu.log(__name__, "multiprocess is not supported: "
                          "detex_tpu parallelizes over the device mesh "
                          "automatically (the reference also rejects it, "
                          "subspace.py:1842-1845)", level="error")
        if trigCon not in (0, 1):
            detex_tpu.log(__name__, "trigCon must be 0 (DS) or 1 (STA/LTA "
                          "of DS; detex_tpu extension — the reference "
                          "rejects 1)", level="error")
        if trigCon == 1 and fillZeros:
            detex_tpu.log(__name__, "trigCon=1 needs the STA/LTA, which is "
                          "disabled by fillZeros", level="error")
        if trigCon == 1 and staltaThreshold is None:
            detex_tpu.log(__name__, "trigCon=1 requires staltaThreshold "
                          "(float or {detector-name: float}); the DS "
                          "Threshold column is not an STA/LTA scale",
                          level="error")
        if os.path.exists(subspaceDB):
            if delOldCorrs:
                os.remove(subspaceDB)
                detex_tpu.log(__name__, "Deleting old subspace database %s"
                              % subspaceDB, pri=True)
            else:
                detex_tpu.log(__name__, "Not deleting old subspace database "
                              "%s" % subspaceDB, pri=True)
        if useSubSpaces:
            TRDF = self.subspaces
            sv = [all(TRDF[sta].SVDdefined) for sta in TRDF]
            if not all(sv):
                detex_tpu.log(__name__, "call SVD before running subspace "
                              "detectors", level="error")
            Det = _SSDetex(TRDF, utcStart, utcEnd, self.cfetcher,
                           self.clusters, subspaceDB, trigCon,
                           triggerLTATime, triggerSTATime, multiprocess,
                           calcHist, self.dtype, estimateMags,
                           classifyEvents, eventCorFile, utcSaves, fillZeros,
                           batchSize=batchSize, devicePrep=devicePrep,
                           staltaThreshold=staltaThreshold)
            self.histSubSpaces = Det.hist
        if useSingles:
            self.setSinglesThresholds()
            TRDF = self.singles
            Det = _SSDetex(TRDF, utcStart, utcEnd, self.cfetcher,
                           self.clusters, subspaceDB, trigCon,
                           triggerLTATime, triggerSTATime, multiprocess,
                           calcHist, self.dtype, estimateMags,
                           classifyEvents, eventCorFile, utcSaves, fillZeros,
                           issubspace=False, batchSize=batchSize,
                           devicePrep=devicePrep,
                           staltaThreshold=staltaThreshold)
            self.histSingles = Det.hist
        if useSubSpaces or useSingles:
            cols = ["FREQMIN", "FREQMAX", "CORNERS", "ZEROPHASE"]
            dffil = pd.DataFrame([self.clusters.filt], columns=cols,
                                 index=[0])
            _util.saveSQLite(dffil, subspaceDB, "filt_params")
            ssinfo, sginfo = self._getInfoDF()
            sshists, sghists = self._getHistograms(useSubSpaces, useSingles)
            if useSubSpaces and ssinfo is not None:
                _util.saveSQLite(ssinfo, subspaceDB, "ss_info")
            if useSingles and sginfo is not None:
                _util.saveSQLite(sginfo, subspaceDB, "sg_info")
            if useSubSpaces and sshists is not None:
                _util.saveSQLite(sshists, subspaceDB, "ss_hist")
            if useSingles and sghists is not None:
                _util.saveSQLite(sghists, subspaceDB, "sg_hist")

    def _getInfoDF(self):
        """Info tables for the database (reference subspace.py:1904-1954)."""
        sslist, sglist = [], []
        for sta in self.Stations:
            if sta not in self.ssStations:
                detex_tpu.log(__name__, "No subspaces on station %s" % sta,
                              pri=True)
                continue
            for num, ss in self.subspaces[sta].iterrows():
                if isinstance(ss.FAS, dict) and len(ss.FAS.keys()) > 1:
                    b1, b2 = ss.FAS["betadist"][0], ss.FAS["betadist"][1]
                else:
                    b1, b2 = np.nan, np.nan
                cols = ["Name", "Sta", "Events", "Threshold", "NumBasisUsed",
                        "beta1", "beta2"]
                dat = [[ss.Name, ss.Station, ",".join(ss.Events),
                        ss.Threshold, ss.NumBasis, b1, b2]]
                sslist.append(pd.DataFrame(dat, columns=cols))
        for sta in self.Stations:
            if sta not in self.singStations:
                detex_tpu.log(__name__, "No singletons on station %s" % sta,
                              pri=True)
                continue
            for num, ss in self.singles[sta].iterrows():
                if isinstance(ss.FAS, list) and len(ss.FAS[0].keys()) > 1:
                    b1, b2 = ss.FAS[0]["betadist"][0], ss.FAS[0]["betadist"][1]
                else:
                    b1, b2 = np.nan, np.nan
                cols = ["Name", "Sta", "Events", "Threshold", "beta1",
                        "beta2"]
                dat = [[ss.Name, ss.Station, ",".join(ss.Events),
                        ss.Threshold, b1, b2]]
                sglist.append(pd.DataFrame(dat, columns=cols))
        ssinfo = pd.concat(sslist, ignore_index=True) if sslist else None
        sginfo = pd.concat(sglist, ignore_index=True) if sglist else None
        return ssinfo, sginfo

    def _getHistograms(self, useSubSpaces, useSingles):
        """Histogram tables for the database
        (reference subspace.py:1956-1995)."""
        cols = ["Name", "Sta", "Value"]
        sshist, sghist = None, None
        if useSubSpaces and hasattr(self, "histSubSpaces"):
            bins = json.dumps(np.asarray(
                self.histSubSpaces["Bins"]).tolist())
            sshists = [pd.DataFrame([["Bins", "Bins", bins]], columns=cols)]
            for sta in self.Stations:
                if sta in self.histSubSpaces:
                    for skey, val in self.histSubSpaces[sta].items():
                        try:
                            vl = json.dumps(np.asarray(val).tolist())
                        except AttributeError:
                            continue
                        sshists.append(pd.DataFrame([[skey, sta, vl]],
                                                    columns=cols))
            sshist = pd.concat(sshists, ignore_index=True)
        if useSingles and hasattr(self, "histSingles"):
            bins = json.dumps(np.asarray(self.histSingles["Bins"]).tolist())
            sghists = [pd.DataFrame([["Bins", "Bins", bins]], columns=cols)]
            for sta in self.Stations:
                if sta in self.histSingles:
                    for skey, val in self.histSingles[sta].items():
                        try:
                            vl = json.dumps(np.asarray(val).tolist())
                        except AttributeError:
                            continue
                        sghists.append(pd.DataFrame([[skey, sta, vl]],
                                                    columns=cols))
            sghist = pd.concat(sghists, ignore_index=True)
        return sshist, sghist

    # ------------------------------------------------------------------
    # Visualization (reference subspace.py:1144-1325)
    # ------------------------------------------------------------------
    def plotThresholds(self, conDatNum=None, xlim=(-.01, .5), show=False,
                       **kwargs):
        """Plot empirical null histograms, beta fits and thresholds."""
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for ind, row in self.subspaces[sta].iterrows():
                if not isinstance(row.FAS, dict) or "hist" not in row.FAS:
                    continue
                fig, ax = plt.subplots()
                bins = np.asarray(row.FAS["bins"])
                centers = 0.5 * (bins[1:] + bins[:-1])
                hist = np.asarray(row.FAS["hist"], dtype=float)
                width = bins[1] - bins[0]
                ax.bar(centers, hist / max(hist.sum() * width, 1e-12),
                       width=width, alpha=0.5, label="empirical null")
                b = row.FAS["betadist"]
                xs = np.linspace(xlim[0] + 1e-6, xlim[1], 400)
                ax.plot(xs, scipy.stats.beta.pdf(xs, b[0], b[1]),
                        label="beta fit")
                ax.axvline(row.Threshold, color="r", ls="--",
                           label="threshold")
                ax.set_xlim(*xlim)
                ax.set_title("%s %s" % (sta, row.Name))
                ax.legend()
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def plotFracEnergy(self, show=False):
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for ind, row in self.subspaces[sta].iterrows():
                if not isinstance(row.FracEnergy, dict):
                    continue
                fig, ax = plt.subplots()
                for ev in row.Events:
                    ax.plot(row.FracEnergy[ev], alpha=.4)
                ax.plot(row.FracEnergy["Average"], "k", lw=2, label="average")
                ax.axvline(row.NumBasis, color="r", ls="--", label="NumBasis")
                ax.set_xlabel("dimension of representation")
                ax.set_ylabel("fractional energy captured")
                ax.set_title("%s %s" % (sta, row.Name))
                ax.legend()
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def plotAlignedEvents(self, show=False):
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for ind, row in self.subspaces[sta].iterrows():
                fig, ax = plt.subplots()
                for ev in row.Events:
                    wf = np.asarray(row.AlignedTD[ev], dtype=float)
                    st = row.SampleTrims
                    if "Starttime" in st:
                        wf = wf[st["Starttime"]:st["Endtime"]]
                    ax.plot(wf / (np.abs(wf).max() or 1), alpha=.5)
                ax.set_title("%s %s aligned" % (sta, row.Name))
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def plotBasisVectors(self, show=False):
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for ind, row in self.subspaces[sta].iterrows():
                if not isinstance(row.SVD, dict):
                    continue
                fig, ax = plt.subplots()
                for i, key in enumerate(row.UsedSVDKeys):
                    ax.plot(np.asarray(row.SVD[key]) + i * 0.2, alpha=.8)
                ax.set_title("%s %s basis" % (sta, row.Name))
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def plotOffsetTimes(self, show=False):
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for ind, row in self.subspaces[sta].iterrows():
                fig, ax = plt.subplots()
                offsets = [row.Stats[x]["offset"] for x in row.Events]
                ax.hist(offsets)
                ax.set_title("%s %s offsets" % (sta, row.Name))
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def printOffsets(self):
        for station in self.ssStations:
            for num, row in self.subspaces[station].iterrows():
                print("%s, %s, min=%3f, max=%3f, range=%3f"
                      % (row.Station, row.Name, row.Offsets[0],
                         row.Offsets[2], row.Offsets[2] - row.Offsets[0]))

    # ------------------------------------------------------------------
    def write(self, filename="subspace.pkl"):
        """Pickle this SubSpace (reference subspace.py:2018-2026)."""
        with open(filename, "wb") as fh:
            pickle.dump(self, fh)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.subspaces[self.ssStations[key]]
        if isinstance(key, str):
            if len(key.split(".")) == 2:
                return self.subspaces[self._stakey2[key]]
            if len(key.split(".")) == 1:
                return self.subspaces[self._stakey1[key]]
        detex_tpu.log(__name__, "%s must be an int or station string" % key,
                      level="error")

    def __len__(self):
        return len(self.subspaces)
