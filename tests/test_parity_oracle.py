"""
Detection-list parity gate: the production engine's ss_df/sg_df rows must
match the independent float64 oracle (detex_tpu.oracle) — trigger indices
exact, DS to 1e-6 (BASELINE north-star parity clause), magnitudes/SNR to
1e-6 — on the synthetic Case1 analog. Also quantifies the f32-vs-f64 SVD
basis drift behind the dtype option.
"""
import os

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct, oracle, util
from detex_tpu.data import fetcher as getdata


@pytest.fixture(scope="module")
def ss(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("parity")
    os.chdir(wd)
    paths = synth_case
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=paths["eventDir"], filt=[1, 8, 2, True],
        stationKey=paths["stationKey"], templateKey=paths["templateKey"],
        trim=[10, 60], saveclust=False, dtype="double")
    cfetcher = getdata.DataFetcher("dir", directoryName=paths["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust, minEvents=2,
                                  conDatFetcher=cfetcher)
    ss.attachPickTimes(pksFile=paths["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=4, useSingles=True,
           backupThreshold=0.25)
    return ss


def _subspace_detectors(ss, sta):
    dets = {}
    for _, row in ss.subspaces[sta].iterrows():
        U = np.array([row.SVD[k] for k in row.UsedSVDKeys])
        s0 = row.SampleTrims["Starttime"]
        s1 = row.SampleTrims["Endtime"]
        wfs = np.array([row.AlignedTD[e][s0:s1] for e in row.Events])
        mags = [row.Stats[e]["magnitude"] for e in row.Events]
        dets[row.Name] = dict(U=U, threshold=float(row.Threshold),
                              offsets=np.atleast_1d(row.Offsets),
                              wfs=wfs, mags=mags, sta=sta)
    return dets


def _single_detectors(ss, sta):
    dets = {}
    for _, row in ss.singles[sta].iterrows():
        if not row.SampleTrims:
            continue
        mptd = list(row.MPtd.values())[0]
        s0 = row.SampleTrims["Starttime"]
        s1 = row.SampleTrims["Endtime"]
        upr = mptd[s0:s1]
        U = np.array([upr / np.linalg.norm(upr)])
        mags = [row.Stats[e]["magnitude"] for e in row.Events]
        dets[row.Name] = dict(U=U, threshold=float(row.Threshold),
                              offsets=np.atleast_1d(row.Offsets),
                              wfs=np.array([upr]), mags=mags, sta=sta)
    return dets


def _sorted(df):
    return df.sort_values(["Sta", "Name", "STMP"]).reset_index(drop=True)


def _assert_lists_match(got, want):
    assert len(got) == len(want), \
        "row counts differ: engine %d vs oracle %d" % (len(got), len(want))
    got, want = _sorted(got), _sorted(want)
    assert list(got.Name) == list(want.Name)
    assert np.allclose(got.STMP, want.STMP, atol=1e-7)          # indices
    assert np.abs(got.DS - want.DS).max() < 1e-6                # DS parity
    assert np.allclose(got.DS_STALTA, want.DS_STALTA, atol=1e-6)
    assert np.allclose(got.MSTAMPmin, want.MSTAMPmin, atol=1e-7)
    assert np.allclose(got.MSTAMPmax, want.MSTAMPmax, atol=1e-7)
    for col in ("Mag", "SNR", "ProEnMag"):
        g = pd.to_numeric(got[col]).to_numpy()
        w = pd.to_numeric(want[col]).to_numpy()
        assert (np.isnan(g) == np.isnan(w)).all()
        m = ~np.isnan(g)
        assert np.allclose(g[m], w[m], atol=1e-6)


def test_subspace_detection_list_parity(ss, tmp_path):
    db = str(tmp_path / "parity_ss.db")
    ss.detex(subspaceDB=db, useSingles=False, estimateMags=True)
    got = util.loadSQLite(db, "ss_df")
    assert got is not None and len(got) > 0

    frames = []
    for sta in ss.ssStations:
        dets = _subspace_detectors(ss, sta)
        nc = list(ss.subspaces[sta].iloc[0].Stats.values())[0]["Nc"]
        skey = ss.clusters.stakey
        skey = skey[skey.STATION == sta.split(".")[1]]
        gen = ss.cfetcher.getConData(skey, returnTimes=True)
        frames.append(oracle.scan_station(gen, dets, nc, ss.clusters.filt,
                                          issubspace=True))
    want = pd.concat(frames, ignore_index=True)
    _assert_lists_match(got, want)


def test_singleton_detection_list_parity(ss, tmp_path):
    db = str(tmp_path / "parity_sg.db")
    ss.detex(subspaceDB=db, useSubSpaces=False, useSingles=True,
             estimateMags=True)
    got = util.loadSQLite(db, "sg_df")
    assert got is not None and len(got) > 0

    frames = []
    for sta in ss.singStations:
        dets = _single_detectors(ss, sta)
        if not dets:
            continue
        nc = list(ss.singles[sta].iloc[0].Stats.values())[0]["Nc"]
        skey = ss.clusters.stakey
        skey = skey[skey.STATION == sta.split(".")[1]]
        gen = ss.cfetcher.getConData(skey, returnTimes=True)
        frames.append(oracle.scan_station(gen, dets, nc, ss.clusters.filt,
                                          issubspace=False))
    want = pd.concat(frames, ignore_index=True)
    _assert_lists_match(got, want)


@pytest.fixture(scope="module")
def ss_single(synth_case, tmp_path_factory):
    """Same pipeline as ``ss`` but dtype='single' — the f32 production
    path ('single' previously had no list-level
    parity guarantee)."""
    wd = tmp_path_factory.mktemp("parity_single")
    os.chdir(wd)
    paths = synth_case
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=paths["eventDir"], filt=[1, 8, 2, True],
        stationKey=paths["stationKey"], templateKey=paths["templateKey"],
        trim=[10, 60], saveclust=False, dtype="single")
    cfetcher = getdata.DataFetcher("dir", directoryName=paths["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust, minEvents=2,
                                  conDatFetcher=cfetcher)
    ss.attachPickTimes(pksFile=paths["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=4, useSingles=True,
           backupThreshold=0.25)
    return ss


def test_single_dtype_detection_list_parity(ss_single, tmp_path):
    """dtype='single' list-level parity: trigger times exact, DS within
    the documented 2e-5 f32 drift envelope of the float64 oracle (the
    2e-5 batched-scan gate margin in detect.py makes threshold-straddling
    chunks re-verify instead of silently dropping)."""
    ss = ss_single
    db = str(tmp_path / "parity_f32.db")
    ss.detex(subspaceDB=db, useSingles=False, estimateMags=True)
    got = util.loadSQLite(db, "ss_df")
    assert got is not None and len(got) > 0

    frames = []
    for sta in ss.ssStations:
        dets = _subspace_detectors(ss, sta)
        nc = list(ss.subspaces[sta].iloc[0].Stats.values())[0]["Nc"]
        skey = ss.clusters.stakey
        skey = skey[skey.STATION == sta.split(".")[1]]
        gen = ss.cfetcher.getConData(skey, returnTimes=True)
        frames.append(oracle.scan_station(gen, dets, nc, ss.clusters.filt,
                                          issubspace=True))
    want = pd.concat(frames, ignore_index=True)
    assert len(got) == len(want), \
        "row counts differ: engine %d vs oracle %d" % (len(got), len(want))
    got, want = _sorted(got), _sorted(want)
    assert list(got.Name) == list(want.Name)
    assert np.allclose(got.STMP, want.STMP, atol=1e-7)   # indices exact
    assert np.abs(got.DS - want.DS).max() < 2e-5         # f32 envelope
    assert np.allclose(got.DS_STALTA, want.DS_STALTA, atol=1e-3)
    assert np.allclose(got.MSTAMPmin, want.MSTAMPmin, atol=1e-7)
    assert np.allclose(got.MSTAMPmax, want.MSTAMPmax, atol=1e-7)
    for col in ("Mag", "SNR", "ProEnMag"):
        g = pd.to_numeric(got[col]).to_numpy()
        w = pd.to_numeric(want[col]).to_numpy()
        assert (np.isnan(g) == np.isnan(w)).all()
        m = ~np.isnan(g)
        assert np.allclose(g[m], w[m], atol=1e-3)


def test_f32_vs_f64_basis_and_ds_drift(ss):
    """Quantify the dtype='single' drift the 'double' path eliminates."""
    from detex_tpu.ops import ds as dsops
    from detex_tpu.ops import svd as svdops
    sta = ss.ssStations[0]
    row = ss.subspaces[sta].iloc[0]
    s0, s1 = row.SampleTrims["Starttime"], row.SampleTrims["Endtime"]
    arr = np.vstack([row.AlignedTD[e][s0:s1] -
                     np.mean(row.AlignedTD[e][s0:s1]) for e in row.Events])
    U64, s64 = svdops.svd_basis(arr, dtype="double")
    U32, s32 = svdops.svd_basis(arr, dtype="single")
    # singular values agree to f32 precision
    assert np.allclose(s32, s64, rtol=1e-4)
    # leading basis vectors agree up to sign to ~1e-3 (the drift SVD in
    # f32 introduces — why dtype='double' exists)
    k = len(row.UsedSVDKeys)
    for i in range(k):
        dot = abs(np.dot(U32[:, i], U64[:, i]))
        assert dot > 1 - 1e-3
    # DS drift between the f32 production kernel and the f64 oracle stays
    # inside the documented 2e-5 envelope
    rng = np.random.default_rng(0)
    nc = list(row.Stats.values())[0]["Nc"]
    U = np.array([row.SVD[kk] for kk in row.UsedSVDKeys])
    x = rng.standard_normal(1 << 15)
    bank = dsops.build_bank([U], nc, len(x))
    d32 = dsops.run_bank(x, bank, nc)[0]
    d64 = dsops.ds_numpy(x, U, nc)
    assert np.abs(d32 - d64).max() < 2e-5