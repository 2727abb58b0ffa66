"""End-to-end detection with fused device preprocessing must find the same
events as the host-prep path."""
import os

import pytest

from detex_tpu import construct, util
from detex_tpu.data import fetcher as getdata


@pytest.fixture(scope="module")
def ss(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("dp")
    os.chdir(wd)
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=[1, 8, 2, True],
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=[10, 60],
        fileName=str(wd / "c.pkl"), saveclust=False)
    cfetch = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    s = construct.createSubSpace(Pf=1e-9, clust=clust,
                                 conDatFetcher=cfetch)
    s.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    s.SVD(threshold=0.4, useSingles=False)
    return s, wd


def test_deviceprep_with_decimation(synth_case, tmp_path):
    """devicePrep with decimate: spectral resample on device must find the
    same events as the host filter+decimate path."""
    os.chdir(tmp_path)
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=[1, 5, 2, True],
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=[10, 60],
        decimate=2, fileName=str(tmp_path / "cd.pkl"), saveclust=False)
    cfetch = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    s = construct.createSubSpace(Pf=1e-9, clust=clust,
                                 conDatFetcher=cfetch)
    s.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    s.SVD(threshold=0.4, useSingles=False)
    db_host = str(tmp_path / "host_d.db")
    db_dev = str(tmp_path / "dev_d.db")
    s.detex(subspaceDB=db_host, estimateMags=False)
    s.detex(subspaceDB=db_dev, estimateMags=False, devicePrep=True)
    host = util.loadSQLite(db_host, "ss_df")
    dev = util.loadSQLite(db_dev, "ss_df")
    assert host is not None and dev is not None
    assert len(host) == len(dev)
    host = host.sort_values("STMP").reset_index(drop=True)
    dev = dev.sort_values("STMP").reset_index(drop=True)
    assert (abs(host.STMP - dev.STMP) < 0.5).all()
    assert (abs(host.DS - dev.DS) < 1e-3).all()


def test_deviceprep_gate_at_threshold_margin(ss):
    """Adversarial gate probe: detections sitting
    within ~the devicePrep gate margin of threshold must survive the
    spectral-vs-SOS filter discrepancy. Thresholds are re-set to 1e-3
    BELOW each detector's observed peak DS — far inside the 0.005 gate
    margin — so a device maxds depressed by the filter discrepancy would
    silently drop the detection if the margin were wrong."""
    s, wd = ss
    db_host = str(wd / "host_margin.db")
    db_dev = str(wd / "dev_margin.db")
    # observed host-path peaks per detector (from a plain run)
    db_probe = str(wd / "probe.db")
    s.detex(subspaceDB=db_probe, estimateMags=False)
    probe = util.loadSQLite(db_probe, "ss_df")
    assert probe is not None and len(probe) > 0
    peak = probe.groupby("Name").DS.max()
    orig = {}
    for sta in s.ssStations:
        df = s.subspaces[sta]
        orig[sta] = df.Threshold.copy()
        df.Threshold = [max(float(peak.get(nm, t)) - 1e-3, 0.05)
                        for nm, t in zip(df.Name, df.Threshold)]
    try:
        s.detex(subspaceDB=db_host, estimateMags=False)
        s.detex(subspaceDB=db_dev, estimateMags=False, devicePrep=True)
    finally:
        for sta, th in orig.items():
            s.subspaces[sta].Threshold = th
    host = util.loadSQLite(db_host, "ss_df")
    dev = util.loadSQLite(db_dev, "ss_df")
    assert host is not None and len(host) > 0
    assert dev is not None
    # every near-threshold detection the host path emits must also be
    # emitted through the devicePrep gate (same rows: host recompute
    # produces identical values once the gate passes the chunk)
    assert len(dev) == len(host)
    host = host.sort_values(["Name", "STMP"]).reset_index(drop=True)
    dev = dev.sort_values(["Name", "STMP"]).reset_index(drop=True)
    assert list(host.Name) == list(dev.Name)
    assert (abs(host.STMP - dev.STMP) < 1e-6).all()
    assert (abs(host.DS - dev.DS) < 1e-9).all()


def test_deviceprep_matches_host_detections(ss):
    s, wd = ss
    db_host = str(wd / "host.db")
    db_dev = str(wd / "dev.db")
    s.detex(subspaceDB=db_host, estimateMags=False)
    s.detex(subspaceDB=db_dev, estimateMags=False, devicePrep=True)
    host = util.loadSQLite(db_host, "ss_df")
    dev = util.loadSQLite(db_dev, "ss_df")
    assert host is not None and dev is not None
    # same detections: one row per event within a sample of each other
    assert len(host) == len(dev)
    host = host.sort_values("STMP").reset_index(drop=True)
    dev = dev.sort_values("STMP").reset_index(drop=True)
    assert (abs(host.STMP - dev.STMP) < 0.2).all()
    assert (abs(host.DS - dev.DS) < 1e-3).all()
    # histograms agree closely (device prep differs only at chunk edges)
    hh = util.loadSQLite(db_host, "ss_hist")
    dh = util.loadSQLite(db_dev, "ss_hist")
    assert hh is not None and dh is not None


def test_deviceprep_fold_route_matches_host(ss, monkeypatch):
    """With every bank past the overlap-save size rule (budget 0), the
    engine builds OVERLAP-SAVE banks and devicePrep rides the fold-batch
    scan through the split batched-prep path (scan_chunks_raw ->
    prep_multiplex_batch -> scan_chunks) — detections must match the
    host-prep path like the monolithic kernel does."""
    from detex_tpu.ops import ds as dsops
    from detex_tpu.parallel import scan as pscan
    monkeypatch.setattr(dsops, "OS_SPECTRA_BUDGET", 0)
    monkeypatch.setenv("DETEX_TPU_MESH", "0")   # single-device route
    before = pscan.ROUTE_COUNTS["fold+devicePrep"]
    s, wd = ss
    db_host = str(wd / "host_fold.db")
    db_dev = str(wd / "dev_fold.db")
    s.detex(subspaceDB=db_host, estimateMags=False)
    s.detex(subspaceDB=db_dev, estimateMags=False, devicePrep=True)
    host = util.loadSQLite(db_host, "ss_df")
    dev = util.loadSQLite(db_dev, "ss_df")
    assert host is not None and dev is not None
    assert len(host) == len(dev)
    host = host.sort_values("STMP").reset_index(drop=True)
    dev = dev.sort_values("STMP").reset_index(drop=True)
    assert (abs(host.STMP - dev.STMP) < 0.2).all()
    assert (abs(host.DS - dev.DS) < 1e-3).all()
    assert pscan.ROUTE_COUNTS["fold+devicePrep"] > before


def test_deviceprep_fold_route_sharded(ss, monkeypatch):
    """Mesh + devicePrep + overlap-save bank: the batched device prep
    runs INSIDE the shard body (scan_chunks_raw_sharded -> per-shard
    prep_multiplex_batch -> fold scan) instead of regressing to
    full-length-spectra banks. The 8-virtual-device mesh run must emit
    the same detections as host prep."""
    from detex_tpu.ops import ds as dsops
    from detex_tpu.parallel import scan as pscan
    monkeypatch.setattr(dsops, "OS_SPECTRA_BUDGET", 0)
    monkeypatch.delenv("DETEX_TPU_MESH", raising=False)   # mesh ON
    before = pscan.ROUTE_COUNTS["fold+sharded+devicePrep"]
    s, wd = ss
    db_host = str(wd / "host_fold_mesh.db")
    db_dev = str(wd / "dev_fold_mesh.db")
    s.detex(subspaceDB=db_host, estimateMags=False)
    s.detex(subspaceDB=db_dev, estimateMags=False, devicePrep=True)
    host = util.loadSQLite(db_host, "ss_df")
    dev = util.loadSQLite(db_dev, "ss_df")
    assert host is not None and dev is not None
    assert len(host) == len(dev)
    host = host.sort_values("STMP").reset_index(drop=True)
    dev = dev.sort_values("STMP").reset_index(drop=True)
    assert (abs(host.STMP - dev.STMP) < 0.2).all()
    assert (abs(host.DS - dev.DS) < 1e-3).all()
    assert pscan.ROUTE_COUNTS["fold+sharded+devicePrep"] > before
