"""Detector export/load + production scan API finds planted events."""
import os

import numpy as np
import pytest

import detex_tpu
from detex_tpu import construct, serving
from detex_tpu.construct import _applyFilter, multiplex
from detex_tpu.data import fetcher as getdata


@pytest.fixture(scope="module")
def deployment(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve")
    os.chdir(wd)
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=[1, 8, 2, True],
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=[10, 60],
        fileName=str(wd / "clust.pkl"), saveclust=False)
    cfetch = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust,
                                  conDatFetcher=cfetch)
    ss.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    ss.SVD(threshold=0.4, useSingles=True)
    path = str(wd / "detectors.npz")
    serving.export_detectors(ss, path)
    return dict(path=path, cfetch=cfetch, synth=synth_case)


def test_export_load_roundtrip(deployment):
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    assert len(dep) == 2
    sd = dep["TA.S00"]
    assert sd["nc"] == 3
    names = [n for b in sd["banks"] for n in b["names"]]
    assert any(n.startswith("SS") for n in names)
    assert any(n.startswith("SG") for n in names)
    for b in sd["banks"]:
        assert (b["thresholds"] == 0.4).all()


def test_sharded_serving_scan(deployment):
    """The deployment artifact scanned over an 8-device mesh yields the
    same triggers as the single-device path."""
    from detex_tpu.parallel import mesh as pmesh
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    synth = deployment["synth"]
    cat = synth["cat"]
    fet = deployment["cfetch"]
    starts = [cat.t0 + h * 3600.0 for h in range(8)]
    chunks = []
    for s in starts:
        st = fet.getStream(s, s + 3720, "TA", "S00",
                           ["BHE", "BHN", "BHZ"], "*")
        st = _applyFilter(st, [1, 8, 2, True])
        chunks.append(multiplex(st, 3))
    L = min(len(c) for c in chunks)
    X = np.stack([c[:L] for c in chunks])
    mesh = pmesh.make_mesh(8)
    res_sharded = serving.scan_station(dep, "TA.S00", X, mesh=mesh)
    res_single = serving.scan_station(dep, "TA.S00", X)
    for rs, r1 in zip(res_sharded, res_single):
        assert np.allclose(rs["hist"], r1["hist"])
        assert np.allclose(rs["maxds"], r1["maxds"], atol=1e-5)
        assert (rs["trig_count"] == r1["trig_count"]).all()


def test_scan_finds_planted_events(deployment):
    """Load the artifact, scan preprocessed chunks covering a hidden event,
    and recover it through the serving API."""
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    synth = deployment["synth"]
    cat = synth["cat"]
    hidden = cat.hidden[0]
    t0 = cat.t0 + (int((hidden["time"] - cat.t0) // 3600)) * 3600.0
    fet = deployment["cfetch"]
    starts = [t0 - 3600, t0, t0 + 3600]
    chunks = []
    for s in starts:
        st = fet.getStream(s, s + 3720, "TA", "S00",
                           ["BHE", "BHN", "BHZ"], "*")
        st = _applyFilter(st, [1, 8, 2, True])
        chunks.append(multiplex(st, 3))
    L = min(len(c) for c in chunks)
    X = np.stack([c[:L] for c in chunks])
    res = serving.scan_station(dep, "TA.S00", X)
    df = serving.triggers_to_frame(dep, "TA.S00", res, starts)
    assert len(df) >= 1
    best = df.loc[df.DS.idxmax()]
    assert best.DS > 0.6
    # predicted origin window brackets the true origin
    assert best.MSTAMPmin - 10 < hidden["time"] < best.MSTAMPmax + 10
    # histogram totals equal the number of DS samples scanned
    tot = sum(r["hist"].sum(axis=-1).max() for r in res)
    assert tot > 0


def test_scan_station_valid_lens_masks_pad(deployment):
    """A zero-padded chunk with valid_lens must produce the same DS maxima
    and triggers as scanning the truncated chunk itself (pad windows once
    entered hist/maxds/triggers)."""
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    synth = deployment["synth"]
    cat = synth["cat"]
    fet = deployment["cfetch"]
    s = cat.t0 + 3600.0
    st = fet.getStream(s, s + 3720, "TA", "S00", ["BHE", "BHN", "BHZ"], "*")
    st = _applyFilter(st, [1, 8, 2, True])
    x = multiplex(st, 3)
    L0 = (int(len(x) * 0.6) // 3) * 3
    xpad = np.zeros((1, len(x)), np.float32)
    xpad[0, :L0] = x[:L0]

    res_masked = serving.scan_station(dep, "TA.S00", xpad,
                                      valid_lens=[L0])
    res_exact = serving.scan_station(dep, "TA.S00",
                                     np.asarray(x[:L0], np.float32)[None])
    for rm, re in zip(res_masked, res_exact):
        assert np.allclose(rm["maxds"], re["maxds"], atol=1e-5)
        assert (rm["trig_count"] == re["trig_count"]).all()
        assert np.allclose(rm["hist"], re["hist"])


def test_scan_station_calc_hist_off(deployment):
    """calc_hist=False skips the DS histogram (zeros) without changing
    maxima or triggers."""
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    synth = deployment["synth"]
    fet = deployment["cfetch"]
    s = synth["cat"].t0 + 7200.0
    st = fet.getStream(s, s + 3720, "TA", "S00", ["BHE", "BHN", "BHZ"], "*")
    st = _applyFilter(st, [1, 8, 2, True])
    X = np.asarray(multiplex(st, 3), np.float32)[None]
    r_on = serving.scan_station(dep, "TA.S00", X)
    r_off = serving.scan_station(dep, "TA.S00", X, calc_hist=False)
    for a, b in zip(r_on, r_off):
        assert (b["hist"] == 0).all() and a["hist"].sum() > 0
        assert np.allclose(a["maxds"], b["maxds"])
        assert (a["trig_count"] == b["trig_count"]).all()
        assert (a["trig_idx"] == b["trig_idx"]).all()


def test_scan_station_raw_matches_host_prep(deployment):
    """scan_station_raw (fused on-device detrend + bandpass, the engine's
    devicePrep path exposed through the serving API) must agree with
    scan_station on host-filtered chunks to the spectral-vs-SOS filter
    tolerance, on raw chunks straddling a hidden event."""
    dep = serving.load_detectors(deployment["path"], chunk_sec=3600,
                                 conBuff=120)
    assert dep["TA.S00"]["filt"] == [1, 8, 2, True]
    synth = deployment["synth"]
    cat = synth["cat"]
    hidden = cat.hidden[0]
    t0 = cat.t0 + (int((hidden["time"] - cat.t0) // 3600)) * 3600.0
    fet = deployment["cfetch"]
    starts = [t0, t0 + 3600]
    raw, host = [], []
    order = ["BHE", "BHN", "BHZ"]
    for s in starts:
        st = fet.getStream(s, s + 3720, "TA", "S00", order, "*")
        raw.append(np.stack([
            np.asarray(st.select(channel=c)[0].data, np.float32)
            for c in order]))
        host.append(multiplex(_applyFilter(st.copy(), [1, 8, 2, True]), 3))
    L = min(r.shape[1] for r in raw)
    Xc = np.stack([r[:, :L] for r in raw])
    Lm = min(len(h) for h in host)
    X = np.stack([h[:Lm] for h in host])
    res_raw = serving.scan_station_raw(dep, "TA.S00", Xc)
    res_host = serving.scan_station(dep, "TA.S00", X)
    found = False
    for rr, rh in zip(res_raw, res_host):
        assert rr["maxds"].shape == rh["maxds"].shape
        assert np.allclose(rr["maxds"], rh["maxds"], atol=5e-3)
        found = found or (rr["maxds"] > 0.6).any()
    assert found          # the planted event clears threshold either way
