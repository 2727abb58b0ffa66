"""Multi-station engine runs: the production
engine dispatches device batches asynchronously and drains them across
station boundaries (detect._SSDetex._inflight), so the device never idles
during another station's host prep. The SubSpace.db it produces must be
row-identical to a forced single-device, serially-materialized run — over
MORE than two stations."""
import os

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct, util
from detex_tpu.data import fetcher as getdata


@pytest.fixture(scope="module")
def synth4(tmp_path_factory):
    """4-station synthetic catalog (smaller span than the session-wide
    2-station fixture)."""
    from detex_tpu.data.synth import SynthCatalog
    root = tmp_path_factory.mktemp("case4sta")
    cat = SynthCatalog(n_sources=2, events_per_source=3, n_singles=1,
                       n_stations=4, sr=25.0, span_hours=14, seed=7,
                       noise=0.04)
    cat.add_hidden_events(n=2, mag=1.4, sources=[0, 1])
    return cat.write_directories(str(root), tb4=10, taft=60)


@pytest.fixture(scope="module")
def ss4(synth4, tmp_path_factory):
    wd = tmp_path_factory.mktemp("eng4")
    os.chdir(wd)
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth4["eventDir"], filt=[1, 8, 2, True],
        stationKey=synth4["stationKey"], templateKey=synth4["templateKey"],
        trim=[10, 60], saveclust=False)
    cfetcher = getdata.DataFetcher("dir", directoryName=synth4["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust, minEvents=2,
                                  conDatFetcher=cfetcher)
    ss.attachPickTimes(pksFile=synth4["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=4, useSingles=True,
           backupThreshold=0.25)
    return ss


def _rows(db, table):
    df = util.loadSQLite(db, table)
    if df is None:
        return pd.DataFrame()
    return df.sort_values(["Sta", "Name", "STMP"]).reset_index(drop=True)


def test_four_station_mesh_matches_serial(ss4, tmp_path, monkeypatch):
    import jax
    assert len(jax.devices()) >= 8
    assert len(ss4.ssStations) >= 4     # every station got subspaces
    db_mesh = str(tmp_path / "mesh4.db")
    db_ser = str(tmp_path / "serial4.db")
    monkeypatch.delenv("DETEX_TPU_MESH", raising=False)
    ss4.detex(subspaceDB=db_mesh, useSingles=True, estimateMags=True,
              batchSize=8)
    monkeypatch.setenv("DETEX_TPU_MESH", "0")
    ss4.detex(subspaceDB=db_ser, useSingles=True, estimateMags=True,
              batchSize=8)
    for table in ("ss_df", "sg_df"):
        got = _rows(db_mesh, table)
        want = _rows(db_ser, table)
        assert len(got) == len(want)
        if len(got) == 0:
            continue
        assert list(got.Name) == list(want.Name)
        assert list(got.Sta) == list(want.Sta)
        assert np.allclose(got.STMP, want.STMP, atol=1e-9)
        assert np.allclose(got.DS, want.DS, atol=1e-9)
    # detections found on all 4 stations (the planted repeats)
    ssdf = _rows(db_mesh, "ss_df")
    assert len(ssdf) > 0
    assert len(set(ssdf.Sta)) >= 4
    # histograms identical too (psum merge vs serial accumulation)
    hm = util.loadSQLite(db_mesh, "ss_hist").sort_values(
        ["Sta", "Name"]).reset_index(drop=True)
    hs = util.loadSQLite(db_ser, "ss_hist").sort_values(
        ["Sta", "Name"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(hm, hs)
