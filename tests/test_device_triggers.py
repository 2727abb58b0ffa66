"""Device-windowed dense re-verify (round 4): STA/LTA + trigger
extraction run inside the bank's device program and only per-trigger
indices/values cross device->host (ops/triggers.trigger_rows_device via
ops/ds.run_bank_triggers_batch). Must be result-identical to the host
chain it replaces (detect._materializeOne's download-row / upload-for-
STA-LTA / upload-for-extraction round trips)."""
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct, util
from detex_tpu.data import fetcher as getdata
from detex_tpu.ops import stalta as _stalta
from detex_tpu.ops import triggers as _triggers


def _host_chain(row, thr, sta_n, lta_n, buff, K, use_stalta):
    """The exact host chain from detect._materializeOne: inf-zeroing,
    device STA/LTA of the host row, while-loop extraction, gathers."""
    dsvec = np.asarray(row, np.float32)
    if dsvec.max() > 1.1:
        dsvec = np.where(np.isfinite(dsvec), dsvec, 0.0)
    sl = None
    if use_stalta:
        sl = np.asarray(_stalta.ds_stalta(dsvec, lta_n, sta_n))
    idx, cnt = _triggers.extract_triggers(dsvec, float(thr), buff,
                                          max_triggers=K)
    idx = np.asarray(idx)[: int(cnt)]
    return (idx, dsvec[idx], sl[idx] if use_stalta else None)


@pytest.mark.parametrize("use_stalta", [True, False])
def test_trigger_rows_device_matches_host_chain(rng, use_stalta):
    L, Lv, R = 4000, 4608, 5
    sta_n, lta_n, buff, K = 13, 250, 40, 64
    rows = rng.normal(0, 0.05, size=(R, Lv)).astype(np.float32)
    rows[:, L:] = 7.7            # junk past the valid length: must be cut
    thr = np.full(R, 0.4, np.float32)
    # planted peaks: isolated, clustered (suppression), edge-adjacent
    rows[0, [100, 900, 2000]] = [0.8, 0.95, 0.5]
    rows[1, 200:220] = 0.9       # plateau -> argmax first occurrence
    rows[2, 10] = 0.7            # inside the buff-edge case
    rows[2, L - 5] = 0.6         # tail edge case
    rows[3, 500] = 2.0           # max > 1.1 -> inf-zeroing branch taken
    rows[3, 700] = np.inf        # non-finite zeroed before extraction
    rows[4, :] = 0.01            # no triggers at all
    out = _triggers.trigger_rows_device(
        jnp.asarray(rows), jnp.asarray(thr), L, sta_n, lta_n, buff, K,
        use_stalta)
    idx_d, cnt_d, dsv_d, slv_d = [np.asarray(o) for o in out]
    assert int(cnt_d[4]) == 0
    assert int(cnt_d[0]) >= 3
    for j in range(R):
        idx_h, ds_h, sl_h = _host_chain(rows[j, :L], thr[j], sta_n, lta_n,
                                        buff, K, use_stalta)
        n = int(cnt_d[j])
        assert n == len(idx_h)
        np.testing.assert_array_equal(idx_d[j, :n], idx_h)
        np.testing.assert_array_equal(dsv_d[j, :n], ds_h)
        if use_stalta:
            np.testing.assert_allclose(slv_d[j, :n], sl_h, rtol=1e-6)


def test_run_bank_triggers_batch_matches_rows_batch(rng):
    """ds.run_bank_triggers_batch against run_bank_rows_batch + the host
    chain, over a real detector bank on multi-chunk batches (distinct
    valid lengths -> distinct static groups)."""
    from detex_tpu.ops import ds as _ds
    nc, n_c, S = 2, 96, 3
    n = n_c * nc
    U = rng.normal(size=(S, 2, n)).astype(np.float32)
    U /= np.linalg.norm(U, axis=-1, keepdims=True)
    bank = _ds.build_bank([u for u in U], nc, 8000 * nc)
    chunks = [rng.normal(0, 1, size=8000 * nc).astype(np.float32),
              rng.normal(0, 1, size=6100 * nc).astype(np.float32)]
    # plant template 1 inside both chunks so real triggers exist
    for x in chunks:
        x[500 * nc: 500 * nc + n] += 40 * U[1, 0]
    rows_list = [[0, 1], [1, 2]]
    thr_list = [[0.2, 0.3], [0.3, 0.25]]
    srs = [25.0, 25.0]
    lta_t, sta_t = 10.0, 0.5
    got = _ds.run_bank_triggers_batch(chunks, bank, nc, rows_list,
                                      thr_list, srs, lta_t, sta_t, True,
                                      max_triggers=128)
    want_rows = _ds.run_bank_rows_batch(chunks, bank, nc, rows_list)
    assert len(got) == 2
    found = 0
    for ci, (rows, thrs, sr) in enumerate(zip(rows_list, thr_list, srs)):
        for si, thr in zip(rows, thrs):
            idx, ds_at, sl_at = got[ci][si]
            dsvec = want_rows[ci][si]
            idx_h, ds_h, sl_h = _host_chain(
                dsvec, thr, max(int(sta_t * sr), 1), int(lta_t * sr),
                int(20 * sr), 128, True)
            assert len(idx) == len(idx_h)
            np.testing.assert_array_equal(idx, idx_h)
            np.testing.assert_array_equal(ds_at, ds_h)
            np.testing.assert_allclose(sl_at, sl_h, rtol=1e-6)
            found += len(idx)
    assert found > 0                      # the planted events triggered
    # device-resident input path (x_dev): identical to the host-list path
    pad = bank["pad_len"]
    Xd = np.zeros((2, pad), np.float32)
    for i, x in enumerate(chunks):
        Xd[i, :len(x)] = x
    got_dev = _ds.run_bank_triggers_batch(
        chunks, bank, nc, rows_list, thr_list, srs, lta_t, sta_t, True,
        max_triggers=128, x_dev=jnp.asarray(Xd),
        lens_dev=[len(x) for x in chunks])
    for ci in range(2):
        for si in rows_list[ci]:
            for a, b in zip(got[ci][si], got_dev[ci][si]):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ss_small(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("devtrig")
    os.chdir(wd)
    # dtype='single': the default 'double' takes the exact float64 HOST
    # re-verify (ds_numpy) and never reaches the device-windowed path
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=[1, 8, 2, True],
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=[10, 60],
        dtype="single", saveclust=False)
    cfetch = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust, dtype="single",
                                  conDatFetcher=cfetch)
    ss.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, threshold=0.35,
           useSingles=True)
    return ss, wd


def _rows(db, table):
    df = util.loadSQLite(db, table)
    if df is None:
        return pd.DataFrame()
    return df.sort_values(["Sta", "Name", "STMP"]).reset_index(drop=True)


def test_engine_device_triggers_identical(ss_small, tmp_path, monkeypatch):
    """End to end: the engine with the device-windowed re-verify emits a
    SubSpace.db row-identical to the full-row host chain."""
    from detex_tpu.parallel import scan as _pscan
    ss, wd = ss_small
    db_dev = str(tmp_path / "dev.db")
    db_host = str(tmp_path / "host.db")
    monkeypatch.delenv("DETEX_TPU_DEVICE_TRIGGERS", raising=False)
    base_dev = _pscan.ROUTE_COUNTS["dense-reverify-device"]
    ss.detex(subspaceDB=db_dev, useSingles=True, estimateMags=True,
             batchSize=8)
    # the device path genuinely ran (dtype='single'; 'double' would take
    # the exact f64 host chain and make this test vacuous)
    assert _pscan.ROUTE_COUNTS["dense-reverify-device"] > base_dev
    monkeypatch.setenv("DETEX_TPU_DEVICE_TRIGGERS", "0")
    ss.detex(subspaceDB=db_host, useSingles=True, estimateMags=True,
             batchSize=8)
    # single-device (mesh off) exercises the device-batch REUSE path:
    # the re-verify gathers triggered chunks from the scan's uploaded
    # batch instead of re-uploading them
    db_nomesh = str(tmp_path / "nomesh.db")
    monkeypatch.setenv("DETEX_TPU_MESH", "0")
    monkeypatch.delenv("DETEX_TPU_DEVICE_TRIGGERS", raising=False)
    ss.detex(subspaceDB=db_nomesh, useSingles=True, estimateMags=True,
             batchSize=8)
    # retention budget exceeded: the engine must NOT
    # keep the scan batch alive — the re-verify re-uploads its triggered
    # chunks — and the emitted rows stay identical
    db_nokeep = str(tmp_path / "nokeep.db")
    monkeypatch.setenv("DETEX_TPU_REVERIFY_KEEP_MB", "0")
    ss.detex(subspaceDB=db_nokeep, useSingles=True, estimateMags=True,
             batchSize=8)
    monkeypatch.delenv("DETEX_TPU_REVERIFY_KEEP_MB", raising=False)
    n_checked = 0
    for table in ("ss_df", "sg_df"):
        want = _rows(db_host, table)
        for db in (db_dev, db_nomesh, db_nokeep):
            got = _rows(db, table)
            assert len(got) == len(want)
            if len(got) == 0:
                continue
            assert list(got.Name) == list(want.Name)
            assert list(got.Sta) == list(want.Sta)
            np.testing.assert_array_equal(np.asarray(got.STMP),
                                          np.asarray(want.STMP))
            np.testing.assert_array_equal(np.asarray(got.DS),
                                          np.asarray(want.DS))
            np.testing.assert_allclose(np.asarray(got.DS_STALTA, float),
                                       np.asarray(want.DS_STALTA, float),
                                       rtol=1e-6)
            np.testing.assert_allclose(np.asarray(got.Mag, float),
                                       np.asarray(want.Mag, float),
                                       rtol=1e-6, equal_nan=True)
            n_checked += len(got)
    assert n_checked > 0                 # the planted events were found
