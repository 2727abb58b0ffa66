"""
Factories: createCluster (waveform-similarity clustering) and createSubSpace
(subspace construction) — the reference's detex/construct.py rebuilt with
device kernels.

The O(N^2) pairwise correlation loop (reference construct.py:369-394) is a
single batched device call (detex_tpu.ops.xcorr.xcorr_all_pairs); hierarchical
linkage stays on host (scipy, tiny N); alignment uses the invariant tree
walk in detex_tpu.align.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.cluster.hierarchy import linkage

import detex_tpu
from detex_tpu import align as _align
from detex_tpu.core.stream import Stream
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.data import fetcher as getdata
from detex_tpu.data.keys import readKey
from detex_tpu.ops import xcorr as _xcorr

DISSIM_OFFSET = 1.0000001  # reference construct.py:153


# ---------------------------------------------------------------------------
# multiplexing & filtering (reference construct.py:928-1030)
# ---------------------------------------------------------------------------


def multiplex(st, Nc=None, trimTolerance=15, template=False, returnlist=False,
              retst=False):
    """
    Interleave the channels of a Stream into one vector (Fortran-order
    flatten, reference construct.py:928-987). Channels longer than the
    shortest by more than ``trimTolerance`` samples raise (template=True) or
    warn+trim.
    """
    if Nc is None:
        Nc = len(set(tr.stats.channel for tr in st))
    if Nc == 1:
        C1 = np.asarray(st[0].data)
        C = np.asarray(st[0].data)
    else:
        chans = [np.asarray(x.data) for x in st]
        lens = np.array([len(x) for x in chans])
        if lens.max() - lens.min() > trimTolerance:
            netsta = st[0].stats.network + "." + st[0].stats.station
            msg = ("Channel lengths are not within %d on %s from %s to %s"
                   % (trimTolerance, netsta, st[0].stats.starttime,
                      st[0].stats.endtime))
            if template:
                detex_tpu.log(__name__, msg, level="error")
            else:
                detex_tpu.log(__name__, msg + " trimming to shortest channel",
                              level="warning", pri=True)
        trimdim = lens.min()
        C = np.vstack([x[:trimdim] for x in chans])
        C1 = C.flatten(order="F")
    out = [C1]
    if returnlist:
        out.append(C)
    if retst:
        out.append(st)
    return out[0] if len(out) == 1 else out


def _applyFilter(st, filt, decimate=False, dtype="double", fillZeros=False):
    """
    Sort/merge/decimate/trim/detrend/bandpass a Stream
    (reference construct.py:990-1030).
    """
    if st is None or len(st) < 1:
        detex_tpu.log(__name__, "_applyFilter got a stream with 0 length",
                      level="warning")
        return Stream()
    st.sort()
    nc = list(set(x.stats.channel for x in st))
    if len(st) > len(nc):  # fragmented: keep largest chunk or zero-fill
        if fillZeros:
            st = _mergeChannelsFill(st)
        else:
            st = _mergeChannels(st)
    if not len(st) == len(nc) or len(st) < 1:
        sta = st[0].stats.station if len(st) else "?"
        detex_tpu.log(__name__, "Stream is too fractured on %s" % sta,
                      level="warning")
        return Stream()
    if decimate:
        st.decimate(decimate)
    startTrim = max(x.stats.starttime.timestamp for x in st)
    endTrim = min(x.stats.endtime.timestamp for x in st)
    if startTrim > endTrim:
        return Stream()
    st.trim(starttime=UTCDateTime(startTrim), endtime=UTCDateTime(endTrim))
    st = st.split()
    st.detrend("linear")
    if isinstance(filt, (list, tuple)) and filt is not None:
        st.filter("bandpass", freqmin=filt[0], freqmax=filt[1],
                  corners=filt[2], zerophase=filt[3])
    if dtype == "single":
        for tr in st:
            tr.data = tr.data.astype(np.float32)
    return st


def _mergeChannels(st):
    """Keep the longest continuous chunk common to all channels
    (reference construct.py:1033-1066)."""
    st1 = st.copy()
    st1.merge(fill_value=0.0)
    start = max(x.stats.starttime.timestamp for x in st1)
    end = min(x.stats.endtime.timestamp for x in st1)
    if start > end:
        return Stream()
    st1.trim(starttime=UTCDateTime(start), endtime=UTCDateTime(end))
    if len(st1) < 1:
        return Stream()
    ar_len = min(len(x.data) for x in st1)
    ar = np.ones(ar_len)
    for tr in st1:
        ar = ar * tr.data[:ar_len]
    if (ar == 0.0).any():
        # longest run where the product is nonzero on all channels,
        # vectorized: run boundaries are the sign changes of the mask
        nz = (ar != 0.0).astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate(([0], nz, [0]))))
        starts, ends = edges[::2], edges[1::2]
        if len(starts) == 0:
            return Stream()
        k = int(np.argmax(ends - starts))
        best_start, best_len = int(starts[k]), int(ends[k] - starts[k])
        sr = st1[0].stats.sampling_rate
        t0 = UTCDateTime(start + best_start / sr)
        t1 = UTCDateTime(start + (best_start + best_len - 1) / sr)
        st.trim(starttime=t0, endtime=t1)
        return st
    return st1


def _mergeChannelsFill(st):
    st.merge(fill_value=0.0)
    return st


def _checkClusterInputs(filt, dtype, trim, decimate):
    """Validate key inputs (reference construct.py:1074-1101)."""
    if filt is not None and len(filt) != 4:
        detex_tpu.log(__name__, "filt must either be None (no filter) or a "
                      "len 4 list or tuple", level="error")
    if dtype not in ("double", "single"):
        detex_tpu.log(__name__, "dtype must be 'double' or 'single', not %s"
                      % dtype, level="warning", pri=True)
        dtype = "double"
    if trim is not None:
        if len(trim) != 2:
            detex_tpu.log(__name__, "Trim must be a list or tuple of length "
                          "2", level="warning", pri=True)
        elif -trim[0] > trim[1]:
            detex_tpu.log(__name__, "Invalid trim parameters", level="error")
    if decimate is not None and not isinstance(decimate, int):
        detex_tpu.log(__name__, "decimate must be an int", level="error",
                      e=TypeError)


# ---------------------------------------------------------------------------
# event loading (reference construct.py:615-925)
# ---------------------------------------------------------------------------


def _loadEvents(fetcher, filt, trim, stakey, temkey, decimate, dtype,
                enforceOrigin=False, phases=None):
    """Build the per-station TRDF master DataFrame of multiplexed templates
    (reference construct.py:615-655)."""
    columns = ["Events", "MPtd", "Channels", "Stats", "Link", "Clust",
               "Lags", "Subsamp", "CCs", "numEvents"]
    stanets = stakey.NETWORK + "." + stakey.STATION
    TRDF = pd.DataFrame(index=range(len(stanets)), columns=columns)
    TRDF["Station"] = list(stanets)
    TRDF["Keep"] = True
    TRDF = TRDF.astype(object)
    for ind, row in TRDF.iterrows():
        sts, eves, chans, stats = _loadStream(fetcher, filt, trim, decimate,
                                              row.Station, dtype, temkey,
                                              stakey, enforceOrigin,
                                              phases=phases)
        if not isinstance(eves, list):
            TRDF.loc[ind, "Keep"] = False
            continue
        TRDF.at[ind, "Events"] = eves
        TRDF.at[ind, "Channels"] = chans
        TRDF.at[ind, "Stats"] = stats
        TRDF.at[ind, "numEvents"] = len(eves)
        mptd = {}
        for key in eves:
            Nc = stats[key]["Nc"]
            mptd[key] = multiplex(sts[key], Nc)
        TRDF.at[ind, "MPtd"] = mptd
        _testStreamLengths(TRDF, ind)
    TRDF = TRDF[TRDF.Keep]
    TRDF = TRDF.sort_values(by="Station").reset_index(drop=True)
    return TRDF


def _loadStream(fetcher, filt, trim, decimate, station, dtype, temkey,
                stakey, enforceOrigin=False, phases=None):
    """
    Load and precondition every template waveform of one station
    (capability of reference construct.py:852-925).

    Each event stream is filtered/decimated; events that are fractured,
    missing from the template key, shorter than 20% of the station-median
    total length, or carrying a dead (all-zero) channel are rejected with a
    logged reason. Returns (streams, sorted names, channels, stats) dicts,
    or four Nones when fewer than 2 events survive.
    """
    origin_times = {}
    for name, time in zip(temkey.NAME, temkey.TIME):
        origin_times.setdefault(name, time)
    skey = stakey[stakey.STATION == station.split(".")[1]]
    records = {}
    for st, ev in fetcher.getTemData(temkey, skey, trim[0], trim[1],
                                     returnName=True, phases=phases):
        st = _applyFilter(st, filt, decimate, dtype)
        if st is None or len(st) < 1:
            continue
        if ev not in origin_times:
            detex_tpu.log(__name__, "%s not in template key, skipping" % ev,
                          pri=True)
            continue
        chans = [tr.stats.channel for tr in st]
        if len(set(chans)) != len(st) or not len(st):
            detex_tpu.log(__name__, "%s on %s is fractured or channels are "
                          "missing, skipping" % (ev, station), pri=True)
            continue
        if enforceOrigin:
            st.trim(starttime=UTCDateTime(origin_times[ev]), pad=True,
                    fill_value=0.0)
        hdr = st[0].stats
        records[ev] = dict(
            st=st, channels=chans,
            stats={"processing": hdr.processing,
                   "sampling_rate": hdr.sampling_rate,
                   "starttime": hdr.starttime.timestamp,
                   "Nc": len(chans)},
            nsamp=sum(len(tr.data) for tr in st),
            dead=any(not np.any(tr.data) for tr in st))
    if not records:
        return None, None, None, None
    median_len = np.median([r["nsamp"] for r in records.values()])
    for ev in list(records):
        if records[ev]["nsamp"] < 0.2 * median_len:
            detex_tpu.log(__name__, "%s is fractured or missing data, "
                          "removing" % ev, level="warning", pri=True)
            del records[ev]
        elif records[ev]["dead"]:
            detex_tpu.log(__name__, "%s has an all-zero channel, deleting"
                          % ev, level="warning", pri=True)
            del records[ev]
    if len(records) < 2:
        detex_tpu.log(__name__, "Less than 2 events survived preprocessing "
                      "for station %s" % station, level="warning", pri=True)
        return None, None, None, None
    evlist = sorted(records)
    return ({e: records[e]["st"] for e in evlist}, evlist,
            {e: records[e]["channels"] for e in evlist},
            {e: records[e]["stats"] for e in evlist})


def _testStreamLengths(TRDF, ind):
    """Trim templates to the common length; drop out-of-tolerance events
    (reference construct.py:679-698)."""
    row = TRDF.loc[ind]
    lens = np.array([len(v) for v in row.MPtd.values()])
    le = int(np.min(lens[lens > np.median(lens) * .9]))
    keysToKill = [x for x in row.Events if len(row.MPtd[x]) < le]
    for key in list(row.Events):
        row.MPtd[key] = row.MPtd[key][:le]
    newEvents = [x for x in row.Events if x not in keysToKill]
    TRDF.at[ind, "Events"] = newEvents
    for key in keysToKill:
        detex_tpu.log(__name__, "%s on %s is out of length tolerance, "
                      "removing" % (key, row.Station), level="warning",
                      pri=True)
        row.MPtd.pop(key, None)


def _flatNoNan(mat):
    """Row-major flatten with NaNs dropped — yields the condensed
    upper-triangle vector for both the square [m, m] matrices and the
    reference-style (m-1) x m DataFrames (reference construct.py:701-707)."""
    if isinstance(mat, pd.DataFrame):
        mat = mat.values
    ar = np.asarray(mat, dtype=np.float64).flatten()
    return ar[~np.isnan(ar)]


def _condensed(mat):
    """Condensed upper triangle (row-major), NaNs preserved."""
    iu = np.triu_indices(mat.shape[0], k=1)
    return np.asarray(mat, dtype=np.float64)[iu]


# ---------------------------------------------------------------------------
# createCluster (reference construct.py:25-171)
# ---------------------------------------------------------------------------


def createCluster(CCreq=0.5,
                  fetch_arg="EventWaveForms",
                  filt=(1, 10, 2, True),
                  stationKey="StationKey.csv",
                  templateKey="TemplateKey.csv",
                  trim=(10, 120),
                  saveclust=True,
                  fileName="clust.pkl",
                  decimate=None,
                  dtype="double",
                  eventsOnAllStations=False,
                  enforceOrigin=False,
                  fillZeros=False,
                  phases=None):
    """
    Cluster template waveforms by all-pairs normalized cross-correlation and
    single-linkage hierarchical clustering; returns a ClusterStream.

    Parameters mirror the reference createCluster (construct.py:25-102).
    The pairwise correlation matrix is computed in one batched device call
    per station rather than an O(N^2) Python loop.
    """
    from detex_tpu.subspace import ClusterStream

    stakey = readKey(stationKey, key_type="station")
    temkey = readKey(templateKey, key_type="template")
    _checkClusterInputs(filt, dtype, trim, decimate)
    if phases is not None:
        phases = readKey(phases, "phases")
    fetcher = getdata.quickFetch(fetch_arg, fillZeros=fillZeros)
    detex_tpu.log(__name__, "Starting IO operations and data checks",
                  pri=True)
    TRDF = _loadEvents(fetcher, filt, trim, stakey, temkey, decimate, dtype,
                       enforceOrigin=enforceOrigin, phases=phases)
    if len(TRDF) < 1:
        detex_tpu.log(__name__, "No events survived pre-processing, check "
                      "DataFetcher and event quality", level="error")
    if eventsOnAllStations:
        eventList = sorted(set.intersection(
            *[set(x) for x in TRDF.Events]))
        if len(eventList) < 2:
            detex_tpu.log(__name__, "less than 2 events in population have "
                          "required stations", level="error")
    for ind, row in TRDF.iterrows():
        detex_tpu.log(__name__, "performing cluster analysis on %s"
                      % row.Station, pri=True)
        if not eventsOnAllStations:
            eventList = row.Events
        if len(row.Events) < 2:
            detex_tpu.log(__name__, "Less than 2 valid events on station %s"
                          % row.Station, level="warning", pri=True)
            continue
        DFcc, DFlag, DFsub = _makeCCMatrices(eventList, row, dtype)
        TRDF.at[ind, "Lags"] = DFlag
        TRDF.at[ind, "CCs"] = DFcc
        TRDF.at[ind, "Subsamp"] = DFsub
        cx = _flatNoNan(DISSIM_OFFSET - DFcc)
        TRDF.at[ind, "Link"] = linkage(cx)
    colstk = ["Station", "Link", "CCs", "Lags", "Subsamp", "Events", "Stats",
              "MPtd", "Channels"]
    trdf = TRDF[colstk]
    eventListAll = sorted(set.union(*[set(x) for x in TRDF.Events]))
    clust = ClusterStream(trdf, temkey, stakey, fetcher, eventListAll, CCreq,
                          list(filt) if filt is not None else None, decimate,
                          list(trim), fileName, eventsOnAllStations,
                          enforceOrigin)
    if saveclust:
        clust.write()
    return clust


def _makeCCMatrices(eventList, row, dtype):
    """All-pairs CC/lag/subsample matrices for one station in one device
    call (replaces reference _makeDFcclags, construct.py:369-394)."""
    X = np.stack([row.MPtd[ev] for ev in eventList])
    ncs = {len(row.Channels[ev]) for ev in eventList}
    if len(ncs) != 1:
        detex_tpu.log(__name__, "Number of channels not equal, cannot "
                      "perform correlation", level="error")
    nc = ncs.pop()
    cc, lag, sub = _xcorr.xcorr_all_pairs(X, nc)
    m = len(eventList)
    cols = np.arange(1, m)
    idx = np.arange(0, m - 1)
    DFcc = pd.DataFrame(cc[:m - 1, 1:], index=idx, columns=cols)
    DFlag = pd.DataFrame(lag[:m - 1, 1:], index=idx, columns=cols)
    DFsub = pd.DataFrame(sub[:m - 1, 1:], index=idx, columns=cols)
    return DFcc, DFlag, DFsub


# ---------------------------------------------------------------------------
# createSubSpace (reference construct.py:177-301)
# ---------------------------------------------------------------------------


def createSubSpace(Pf=10 ** -12, clust="clust.pkl", minEvents=2,
                   dtype="double", conDatFetcher=None):
    """
    Build a SubSpace instance from a ClusterStream: per-cluster alignment via
    the linkage lag tree, common trimming, and per-station subspace/single
    DataFrames (reference construct.py:177-301). SVD/thresholds happen later
    via SubSpace.SVD().
    """
    from detex_tpu import util as _util
    from detex_tpu.subspace import ClusterStream, SubSpace

    if isinstance(clust, str):
        cl = _util.loadClusters(clust)
    elif isinstance(clust, ClusterStream):
        cl = clust
    else:
        detex_tpu.log(__name__, "Invalid clust type, must be a path or "
                      "ClusterStream instance.", level="error", e=ValueError)
    temkey = cl.temkey
    stakey = cl.stakey
    efetcher = cl.fetcher
    if isinstance(conDatFetcher, getdata.DataFetcher):
        cfetcher = conDatFetcher
    elif isinstance(conDatFetcher, str):
        cfetcher = getdata.quickFetch(conDatFetcher)
    else:
        if efetcher.method == "dir":
            cfetcher = getdata.quickFetch(getdata.conDirDefault)
        else:
            cfetcher = efetcher
    TRDF = _loadEvents(efetcher, cl.filt, cl.trim, stakey, temkey,
                       cl.decimate, dtype)
    for ind, row in TRDF.iterrows():
        TRDF.at[ind, "Link"] = cl[row.Station].link
        TRDF.at[ind, "Clust"] = cl[row.Station].clusts
    detex_tpu.log(__name__, "Starting Subspace Construction", pri=True)
    ssDict = {}
    for num, row in TRDF.iterrows():
        staSS = _makeSSDF(row, minEvents)
        if len(staSS) < 1:
            detex_tpu.log(__name__, "No events grouped into subspaces on %s"
                          % row.Station, level="warning", pri=True)
            continue
        for sind, srow in staSS.iterrows():
            eventList = list(srow.Events)
            cc_sub, lag_sub = _getInfoFromClust(cl, srow)
            staSS.at[sind, "CCs"] = cc_sub
            staSS.at[sind, "Lags"] = lag_sub
            cx = _flatNoNan(DISSIM_OFFSET - cc_sub)
            link = linkage(cx)
            staSS.at[sind, "Link"] = link
            delays = _align.alignment_delays(link, cc_sub, lag_sub)
            staSS.at[sind, "AlignedTD"] = _align.align_and_trim(
                srow.MPtd, eventList, delays)
            ustimes = _updateStartTimes(srow, eventList, delays, temkey)
            staSS.at[sind, "Stats"] = ustimes
            offsets = [ustimes[ev]["offset"] for ev in eventList]
            staSS.at[sind, "Offsets"] = [float(np.min(offsets)),
                                         float(np.median(offsets)),
                                         float(np.max(offsets))]
        staOut = staSS.drop(["MPtd", "Link", "Lags", "CCs"], axis=1)
        ssDict[row.Station] = staOut
    singDic = _makeSingleEventDict(cl, TRDF, temkey)
    substream = SubSpace(singDic, ssDict, cl, dtype, Pf, cfetcher)
    detex_tpu.log(__name__, "Finished CreateSubSpace call", pri=True)
    return substream


def _getInfoFromClust(cl, srow):
    """Extract the cluster-event sub-matrices of the station's CC/lag
    matrices (reference construct.py:304-336)."""
    sta = srow.Station
    cll = cl.trdf[cl.trdf.Station == sta].iloc[0]
    full_events = list(cll.Events)
    # both lists are sorted, so cluster positions are increasing and the
    # (i < j) orientation of the full matrices is preserved
    pos = np.array([full_events.index(ev) for ev in srow.Events])
    m = len(pos)
    ccfull = np.asarray(_square_from_df(cll.CCs, len(full_events)))
    lagfull = np.asarray(_square_from_df(cll.Lags, len(full_events),
                                         fill=0.0))
    # fancy-index the cluster rows/cols out in one shot, keep upper triangle
    cc = ccfull[np.ix_(pos, pos)]
    lag = lagfull[np.ix_(pos, pos)]
    lower = ~np.triu(np.ones((m, m), dtype=bool), k=1)
    cc[lower] = np.nan
    lag[lower] = 0.0
    return cc, lag


def _square_from_df(df, m, fill=np.nan):
    """Rebuild an [m, m] upper-triangle matrix from the reference-style
    DataFrame (index 0..m-2, columns 1..m-1)."""
    out = np.full((m, m), fill)
    arr = np.asarray(df.values, dtype=np.float64)
    out[: m - 1, 1:] = arr
    return out


def _updateStartTimes(srow, eventList, delays, temkey):
    """Update per-event start times for alignment trims
    (reference construct.py:346-366)."""
    statsdict = {k: dict(v) for k, v in srow.Stats.items()
                 if k in eventList}
    for ev, dsamp in zip(eventList, delays):
        temtemkey = temkey.loc[temkey.NAME == ev].iloc[0]
        Nc = statsdict[ev]["Nc"]
        sr = statsdict[ev]["sampling_rate"]
        stime = statsdict[ev]["starttime"]
        otime = UTCDateTime(temtemkey.TIME).timestamp
        stime_new = stime + float(dsamp) / (sr * Nc)
        statsdict[ev]["starttime"] = stime_new
        statsdict[ev]["origintime"] = otime
        statsdict[ev]["magnitude"] = temtemkey.MAG
        statsdict[ev]["offset"] = stime_new - otime
    return statsdict


def _makeSSDF(row, minEvents):
    """Reshape a TRDF station row into the per-cluster subspace DataFrame
    (reference construct.py:562-601)."""
    index = range(len(row.Clust))
    columns = [x for x in row.index if x != "Clust"]
    DF = pd.DataFrame(index=index, columns=columns)
    DF = DF.astype(object)
    DF["Name"] = ["SS%d" % x for x in range(len(DF))]
    DF["Station"] = row.Station
    DF["AlignedTD"] = object
    DF["SVD"] = object
    DF["UsedSVDKeys"] = object
    DF["FracEnergy"] = object
    DF["SVDdefined"] = False
    DF["SampleTrims"] = [{} for _ in range(len(DF))]
    DF["Threshold"] = np.nan
    DF["SigDimRep"] = object
    DF["FAS"] = object
    DF["NumBasis"] = 0
    DF["Offsets"] = object
    for ind in DF.index:
        evelist = sorted(row.Clust[ind])
        DF.at[ind, "Events"] = evelist
        DF.at[ind, "numEvents"] = len(evelist)
        DF.at[ind, "MPtd"] = _trimDict(row, "MPtd", evelist)
        DF.at[ind, "Stats"] = _trimDict(row, "Stats", evelist)
        DF.at[ind, "Channels"] = _trimDict(row, "Channels", evelist)
    DF = DF[[len(x) >= minEvents for x in DF.Events]]
    return DF


def _makeSingleEventDict(cl, TRDF, temkey):
    """Per-station DataFrames of singletons (reference
    construct.py:525-559)."""
    singlesdict = {}
    cols = [x for x in TRDF.columns
            if x not in ["Clust", "Link", "Lags", "CCs", "Subsamp"]]
    for num, row in TRDF.iterrows():
        singles = list(cl[row.Station].singles)
        DF = pd.DataFrame(index=range(len(singles)), columns=cols)
        DF = DF.astype(object)
        if len(singles) < 1:
            singlesdict[row.Station] = DF.iloc[:0]
            continue
        for sn, ev in enumerate(singles):
            temtemkey = temkey.loc[temkey.NAME == ev].iloc[0]
            evelist = [ev]
            DF.at[sn, "Station"] = row.Station
            DF.at[sn, "MPtd"] = _trimDict(row, "MPtd", evelist)
            DF.at[sn, "Stats"] = _trimDict(row, "Stats", evelist)
            DF.at[sn, "Channels"] = _trimDict(row, "Channels", evelist)
            otime = UTCDateTime(temtemkey.TIME).timestamp
            stime = DF.at[sn, "Stats"][ev]["starttime"]
            DF.at[sn, "Stats"][ev]["origintime"] = otime
            DF.at[sn, "Stats"][ev]["offset"] = stime - otime
            DF.at[sn, "Stats"][ev]["magnitude"] = temtemkey.MAG
            DF.at[sn, "Events"] = evelist
            DF.at[sn, "Name"] = "SG%d" % sn
        DF["SampleTrims"] = [{} for _ in range(len(DF))]
        DF["FAS"] = object
        DF["Threshold"] = np.nan
        DF["Offsets"] = object
        singlesdict[row.Station] = DF
    return singlesdict


def _trimDict(row, column, evelist):
    """Subset a dict column to the given events
    (reference construct.py:604-610)."""
    temdict = {k: row[column].get(k, None) for k in evelist}
    return {k: v for k, v in temdict.items() if v is not None}


# backwards-compatible aliases matching reference function names
fast_normcorr = _xcorr.normcorr
