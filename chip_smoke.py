#!/usr/bin/env python3
"""
Smoke run of detex_tpu on NVIDIA GPUs: the Detex workflow end to end at
production widths, and the device detection statistic (DS) checked against
the package's float64 references.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the mesh-sharded engine
                                       # against one device, nothing else

One-GPU phases:
  environment   card name and power limit, versions, native library,
                compile-cache directory
  main-path     createCluster -> createSubSpace -> attachPickTimes -> SVD
                -> detex -> detResults on 3 stations x 48 h of 100 Hz
                three-component synthetic data with planted events; every
                planted event must be verified
  ds-parity     parallel.scan.scan_chunks on one (3600 + 120) s x 100 Hz x
                3 ch chunk for a 10-detector D=4 subspace bank, a
                1000-template bank and a prefer_os subspace bank, against
                ops.ds.ds_numpy: max |dDS| <= 2e-5, trigger indices exact,
                histograms equal np.histogram but for one-ULP bin edges
  list-parity   engine detection list vs detex_tpu.oracle over one
                station-day at 100 Hz, dtype 'double' (DS within 1e-6) and
                'single' (DS within 2e-5), trigger times exact
  gpu-tests     the tests marked ``gpu``, in this process

Each phase prints its own lines. The last line of standard output is the
JSON device record, printed only when every phase passed; the exit code is
0 then and 1 otherwise. With no GPU (or fewer than four for --four-cards)
the script exits with code 2 before any phase runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: per-window DS envelope of the float32 device path against float64 (the
#: engine's batched-scan gate margin, detect._materializeOneInner, relies
#: on it)
F32_DS_TOL = 2e-5
SR = 100.0
CHUNK_SEC = 3600.0
BUFF_SEC = 120.0


def require_gpus(n):
    """The first ``n`` GPU devices JAX finds; RuntimeError when there are
    fewer (a CPU-only process has none)."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise RuntimeError("JAX finds no GPU: %s" % e)
    if len(devs) < n:
        raise RuntimeError("need %d GPU(s), JAX finds %d" % (n, len(devs)))
    return devs[:n]


def card_lines():
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class Timer(object):
    """Wall time of named steps, printed with the card label."""

    def __init__(self, label):
        self.label = label

    def __call__(self, name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        print("  step %-16s %9.2f s  [%s]" % (name, time.perf_counter() - t0,
                                             self.label), flush=True)
        return out


def synth_dataset(root, n_stations, hours, sr=SR, seed=11, n_hidden=4):
    """Three-component synthetic catalog + continuous data with planted
    (unlisted) repeats of two sources; returns (catalog, paths)."""
    from detex_tpu.data.synth import SynthCatalog
    cat = SynthCatalog(n_sources=2, events_per_source=3, n_singles=1,
                       n_stations=n_stations, sr=sr, span_hours=hours,
                       seed=seed, noise=0.04)
    cat.add_hidden_events(n=n_hidden, mag=1.4, sources=[0, 1])
    paths = cat.write_directories(root, tb4=10, taft=60,
                                  conDatDuration=CHUNK_SEC, conBuff=BUFF_SEC)
    return cat, paths


def build_subspace(paths, dtype, timer=None):
    """createCluster -> createSubSpace -> attachPickTimes -> SVD with 30 s
    templates; returns (SubSpace, continuous-data fetcher)."""
    import detex_tpu
    from detex_tpu.data import fetcher as getdata
    run = timer or (lambda _name, fn, *a, **kw: fn(*a, **kw))
    clust = run("createCluster", detex_tpu.createCluster, CCreq=0.5,
                fetch_arg=paths["eventDir"], filt=[1, 8, 2, True],
                stationKey=paths["stationKey"],
                templateKey=paths["templateKey"], trim=[10, 60],
                saveclust=False, dtype=dtype)
    cf = getdata.DataFetcher("dir", directoryName=paths["conDir"],
                             conDatDuration=CHUNK_SEC, conBuff=BUFF_SEC)
    ss = run("createSubSpace", detex_tpu.createSubSpace, Pf=1e-9,
             clust=clust, minEvents=2, conDatFetcher=cf, dtype=dtype)
    run("attachPickTimes", ss.attachPickTimes, pksFile=paths["phaseKey"],
        defaultDuration=30)
    run("SVD", ss.SVD, selectCriteria=2, selectValue=0.9, conDatNum=4,
        useSingles=True, backupThreshold=0.25)
    return ss, cf


def template_lengths(ss):
    """Per-channel template length n_c of every detector."""
    out = []
    for frames in (ss.subspaces, ss.singles):
        for sta, df in frames.items():
            for _, row in df.iterrows():
                tr = row.SampleTrims
                if tr:
                    nc = list(row.Stats.values())[0]["Nc"]
                    out.append((tr["Endtime"] - tr["Starttime"]) // nc)
    return out


def engine_bank(ss, sta, sr, nc=3):
    """Station ``sta``'s subspace bank as the engine builds it
    (detect._prepareDetectors) and its +inf gate thresholds."""
    import numpy as np
    from detex_tpu.ops import ds as dsops
    U = [np.array([r.SVD[k] for k in r.UsedSVDKeys])
         for _, r in ss.subspaces[sta].iterrows()]
    pad_len = int((CHUNK_SEC + BUFF_SEC) * sr * nc)
    bank = dsops.build_bank(U, nc, pad_len, pad_S=dsops.pad_rows(len(U)),
                            min_dmax=dsops.pad_dims(max(u.shape[0]
                                                        for u in U)))
    return bank, np.full(int(bank["sum_u"].shape[0]), np.inf, np.float32)


def scan_step_memory(ss, sta, batch, sr):
    """memory_analysis() of the engine's compiled scan step for station
    ``sta``'s subspace bank at ``batch`` chunks."""
    import numpy as np
    from detex_tpu.parallel import scan as pscan
    nc = 3
    bank, th = engine_bank(ss, sta, sr, nc)
    X = np.zeros((batch, bank["pad_len"]), np.float32)
    fn, args, kw, route = pscan.scan_program(
        X, bank, th, nc, int(20 * sr), max_trig=1, calc_triggers=False)
    ma = fn.lower(*args, **kw).compile().memory_analysis()
    return pscan.ROUTE_NAMES[route], ma


def phase_environment(cards):
    import jax
    import numpy
    import pandas
    from detex_tpu import compile_cache, native
    for ln in cards:
        print("  card (nvidia-smi name, power.limit): %s" % ln)
    print("  jax %s | numpy %s | pandas %s" % (
        jax.__version__, numpy.__version__, pandas.__version__))
    print("  devices: %s" % [(d.platform, d.device_kind)
                             for d in jax.devices()])
    print("  native.available(): %s" % native.available())
    print("  compile cache dir: %s" % compile_cache.enable())


def phase_main_path(root, label, n_stations=3, hours=48, sr=SR,
                    want_n_c=3000):
    """The five-step workflow through the public API; every planted event
    must come back verified."""
    from detex_tpu import results, util
    run = Timer(label)
    cat, paths = run("synthesize", synth_dataset, root, n_stations, hours,
                     sr=sr)
    ss, cf = build_subspace(paths, "single", timer=run)
    n_cs = sorted(set(template_lengths(ss)))
    print("  template lengths n_c: %s" % n_cs)
    assert n_cs == [want_n_c], "templates must be 30 s (n_c=%d): %s" % (
        want_n_c, n_cs)
    db = os.path.join(root, "SubSpace.db")
    run("detex", ss.detex, subspaceDB=db, useSingles=True)
    res = run("detResults", results.detResults, requiredNumStations=2,
              veriBuffer=4, ssDB=db, templateKey=paths["templateKey"],
              stationKey=paths["stationKey"], veriFile=paths["veriFile"],
              fetch=cf)
    ssdf = util.loadSQLite(db, "ss_df")
    print("  %s" % repr(res))
    print("  ss_df rows: %d" % (0 if ssdf is None else len(ssdf)))
    nver = 0 if res.Vers is None else len(res.Vers)
    print("  planted %d, verified %d" % (len(cat.hidden), nver))
    assert nver == len(cat.hidden), "not every planted event was verified"
    route, ma = scan_step_memory(ss, ss.ssStations[0], 32, sr)
    print("  scan step (%s, batch 32) memory_analysis: %s" % (route, ma))
    return cat, paths


def _plant(x, u, at, ds_target=0.6):
    """Add ``c * u`` (u unit-norm, length n) at multiplexed sample ``at`` so
    the window's DS is about ds_target (DS ~ c^2 / (c^2 + n) on unit
    noise)."""
    import numpy as np
    n = u.shape[0]
    c = np.sqrt(n * ds_target / (1.0 - ds_target))
    x[at:at + n] += c * u


def dot_precisions(hlo_text):
    """Precision of every dot_general in a lowered StableHLO module."""
    import re
    out = []
    for ln in hlo_text.splitlines():
        if "dot_general" in ln:
            m = re.findall(r"precision = \[(\w+)", ln)
            out.append(m[0] if m else "DEFAULT")
    return out


def _check_bank(name, x, bank, U_list, rows, nc, thr, buff):
    """Scan one chunk with ``bank`` and hold detector ``rows`` to the
    float64 reference; returns the measured maxima."""
    import numpy as np
    from detex_tpu import oracle
    from detex_tpu.ops import ds as dsops
    from detex_tpu.parallel import scan as pscan
    S = int(bank["sum_u"].shape[0])
    th = np.full(S, np.inf, np.float32)
    th[:len(U_list)] = thr
    X = x[None].astype(np.float32)
    fn, args, kw, route = pscan.scan_program(
        X, bank, th, nc, buff, max_trig=16, calc_triggers=True)
    hist, maxds, tidx, tval, tcnt = map(np.asarray, fn(*args, **kw))
    precs = dot_precisions(fn.lower(*args, **kw).as_text())
    dev = dsops.run_bank_batch([X[0]], bank, nc)[0]     # [S, n_valid]
    edges32 = np.asarray(pscan.DEFAULT_BINS, np.float32).astype(np.float64)
    d_ds = d_max = 0.0
    hist_f64_diff = edge_vals = n_trig = 0
    for i in rows:
        ref = dsops.ds_numpy(x, U_list[i], nc)
        d_ds = max(d_ds, float(np.abs(dev[i, :len(ref)] - ref).max()))
        d_max = max(d_max, abs(float(maxds[0, i]) - float(ref.max())))
        want_idx = sorted(oracle.extract_triggers(ref, thr, buff))
        got_idx = sorted(int(v) for v in tidx[0, i, :tcnt[0, i]])
        assert got_idx == want_idx, "%s row %d triggers %s != %s" % (
            name, i, got_idx, want_idx)
        n_trig += len(want_idx)
        # device binning == np.histogram on the same float32 values with
        # the float32 edges the device compares against
        h32, _ = np.histogram(dev[i], bins=edges32)
        assert np.array_equal(hist[i], h32), "%s row %d hist" % (name, i)
        # against float64 edges only values within one ULP of an edge move
        h64, _ = np.histogram(dev[i], bins=pscan.DEFAULT_BINS)
        nbin = len(pscan.DEFAULT_BINS) - 1
        edge = np.round(dev[i].astype(np.float64) * nbin) / nbin
        near = np.abs(dev[i] - edge) <= np.spacing(np.abs(dev[i]))
        hist_f64_diff += int(np.abs(h32 - h64).sum())
        edge_vals += int(near.sum())
    print("  %-10s route=%-12s S=%d rows checked=%d  max|dDS|=%.3g  "
          "max|d maxDS|=%.3g  triggers matched=%d  hist vs float64 edges: "
          "%d counts moved, %d values within one ULP of an edge" % (
              name, pscan.ROUTE_NAMES[route], S, len(rows), d_ds, d_max,
              n_trig, hist_f64_diff, edge_vals))
    print("  %-10s dot_general precisions: %s" % (name, precs))
    assert d_ds <= F32_DS_TOL and d_max <= F32_DS_TOL, name
    assert hist_f64_diff <= 2 * edge_vals, name
    assert n_trig > 0, "%s: no planted trigger among the rows" % name
    assert precs and all(p == "HIGHEST" for p in precs), precs
    return d_ds, d_max


def phase_ds_parity(n_c=3000, chunk_samps=None, n_tpl=1000, net_rows=32,
                    sr=SR, seed=5, net_prefer_os=False):
    """DS of three banks at a real chunk width through parallel.scan
    against ops.ds.ds_numpy (float64)."""
    import numpy as np
    from detex_tpu.ops import ds as dsops
    nc = 3
    n = n_c * nc
    Lc = chunk_samps or int((CHUNK_SEC + BUFF_SEC) * sr * nc)
    buff = int(20 * sr)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(Lc)
    subspaces = [np.linalg.qr(rng.standard_normal((n, 4)))[0].T
                 for _ in range(10)]
    T = rng.standard_normal((n_tpl, n))
    tpls = [(t / np.linalg.norm(t))[None] for t in T]
    step = max((Lc // nc - n_c) // 8, 1) * nc
    _plant(x, subspaces[0][0], 1 * step)
    _plant(x, subspaces[5][2], 3 * step)
    _plant(x, tpls[0][0], 5 * step)
    _plant(x, tpls[-1][0], 7 * step)
    print("  chunk: %d multiplexed samples, n_c=%d" % (Lc, n_c))
    ss_bank = dsops.build_bank(subspaces, nc, Lc, pad_S=dsops.pad_rows(10),
                               min_dmax=4)
    net_bank = dsops.build_bank(tpls, nc, Lc, prefer_os=net_prefer_os,
                                pad_S=dsops.pad_rows(n_tpl))
    os_bank = dsops.build_bank(subspaces, nc, Lc, prefer_os=True,
                               pad_S=dsops.pad_rows(10), min_dmax=4)
    assert not ss_bank.get("os") and net_bank.get("os") and \
        os_bank.get("os")
    net_check = sorted(set(np.linspace(0, n_tpl - 1, net_rows).astype(int)))
    _check_bank("subspace", x, ss_bank, subspaces, range(10), nc, 0.3, buff)
    _check_bank("net%d" % n_tpl, x, net_bank, tpls, net_check, nc, 0.3,
                buff)
    _check_bank("subspace-os", x, os_bank, subspaces, range(10), nc, 0.3,
                buff)


def _subspace_detectors(ss, sta):
    """Oracle detector specs of station ``sta``'s subspaces (as
    tests/test_parity_oracle.py builds them)."""
    import numpy as np
    dets = {}
    for _, row in ss.subspaces[sta].iterrows():
        s0 = row.SampleTrims["Starttime"]
        s1 = row.SampleTrims["Endtime"]
        dets[row.Name] = dict(
            U=np.array([row.SVD[k] for k in row.UsedSVDKeys]),
            threshold=float(row.Threshold),
            offsets=np.atleast_1d(row.Offsets),
            wfs=np.array([row.AlignedTD[e][s0:s1] for e in row.Events]),
            mags=[row.Stats[e]["magnitude"] for e in row.Events], sta=sta)
    return dets


def phase_list_parity(cat, paths, root, hours=24):
    """Engine vs float64 oracle detection lists over one station-day."""
    import numpy as np
    from detex_tpu import oracle, util
    t0 = cat.t0
    t1 = t0 + hours * 3600.0
    for dtype, tol in (("double", 1e-6), ("single", F32_DS_TOL)):
        ss, cf = build_subspace(paths, dtype)
        sta = ss.ssStations[0]
        db = os.path.join(root, "parity_%s.db" % dtype)
        ss.detex(subspaceDB=db, utcStart=t0, utcEnd=t1, useSingles=False,
                 estimateMags=True)
        got = util.loadSQLite(db, "ss_df")
        got = got[got.Sta == sta]
        nc = list(ss.subspaces[sta].iloc[0].Stats.values())[0]["Nc"]
        skey = ss.clusters.stakey
        skey = skey[skey.STATION == sta.split(".")[1]]
        gen = cf.getConData(skey, utcstart=t0, utcend=t1, returnTimes=True)
        want = oracle.scan_station(gen, _subspace_detectors(ss, sta), nc,
                                   ss.clusters.filt, issubspace=True)
        key = ["Sta", "Name", "STMP"]
        got = got.sort_values(key).reset_index(drop=True)
        want = want.sort_values(key).reset_index(drop=True)
        d_ds = float(np.abs(got.DS.to_numpy() - want.DS.to_numpy()).max()) \
            if len(got) == len(want) and len(got) else float("nan")
        print("  %-6s %s: engine %d rows, oracle %d rows, max|dDS|=%.3g "
              "(gate %g)" % (dtype, sta, len(got), len(want), d_ds, tol))
        assert len(got) == len(want) > 0
        assert list(got.Name) == list(want.Name)
        assert np.allclose(got.STMP, want.STMP, rtol=0, atol=1e-7)
        assert d_ds < tol


def phase_gpu_tests():
    """The card-only tests, in this process (one process per card)."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "--rootdir", HERE,
                      os.path.join(HERE, "tests")])
    assert rc == 0, "pytest -m gpu exited %d" % rc


def phase_four_cards(root, n_cards=4, n_stations=1, hours=24, sr=SR):
    """One station-day through SubSpace.detex() on the n-device engine
    mesh and on one device: identical detection lists, equal psum-merged
    histograms, work on every device."""
    import jax
    import numpy as np
    from detex_tpu import util
    from detex_tpu.parallel import scan as pscan
    _, paths = synth_dataset(root, n_stations, hours, sr=sr, n_hidden=2)
    ss, _ = build_subspace(paths, "single")
    os.environ.pop("DETEX_TPU_MESH", None)
    mesh = pscan.engine_mesh()
    assert mesh is not None and mesh.size == n_cards == len(jax.devices())
    print("  mesh: %s over %s" % (dict(mesh.shape), mesh.devices.tolist()))
    before = dict(pscan.ROUTE_COUNTS)
    db_mesh = os.path.join(root, "mesh.db")
    t = time.perf_counter()
    ss.detex(subspaceDB=db_mesh, useSingles=True)
    t_mesh = time.perf_counter() - t
    sharded = {k: v - before.get(k, 0) for k, v in pscan.ROUTE_COUNTS.items()
               if "+sharded" in k and v > before.get(k, 0)}
    assert sharded, "no sharded scan ran: %s" % dict(pscan.ROUTE_COUNTS)
    peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
             for d in jax.devices()]
    print("  sharded routes: %s | peak bytes per device: %s" % (sharded,
                                                                peaks))
    os.environ["DETEX_TPU_MESH"] = "0"
    try:
        db_one = os.path.join(root, "one.db")
        t = time.perf_counter()
        ss.detex(subspaceDB=db_one, useSingles=True)
        t_one = time.perf_counter() - t
    finally:
        os.environ.pop("DETEX_TPU_MESH", None)
    # a sharded batch must put work on every device, not on the first
    # only: each device computes (and holds) its own chunks' maxima
    sta = ss.ssStations[0]
    bank, th = engine_bank(ss, sta, sr)
    X = np.random.default_rng(0).standard_normal(
        (2 * n_cards, bank["pad_len"])).astype(np.float32)
    _, m_shard, *_ = pscan.scan_chunks_sharded(mesh, X, bank, th, 3,
                                               int(20 * sr), max_trig=1)
    _, m_one, *_ = pscan.scan_chunks(X, bank, th, 3, int(20 * sr),
                                     max_trig=1)
    on = sorted({sh.device.id for sh in m_shard.addressable_shards
                 if sh.data.shape[0] > 0})
    print("  sharded maxima computed on devices %s" % on)
    assert len(on) == n_cards, on
    assert np.allclose(np.asarray(m_shard), np.asarray(m_one), rtol=0,
                       atol=F32_DS_TOL)
    # each device held its chunk shard during the engine run (backends
    # without memory stats, such as the CPU, report zeros)
    shard_bytes = X.nbytes // n_cards
    assert not any(peaks) or min(peaks) >= shard_bytes, (peaks, shard_bytes)
    for table in ("ss_df", "sg_df", "ss_hist", "sg_hist"):
        a = util.loadSQLite(db_mesh, table)
        b = util.loadSQLite(db_one, table)
        if a is None and b is None:
            continue
        assert a is not None and b is not None, table
        a = a.reset_index(drop=True)
        b = b.reset_index(drop=True)
        assert a.shape == b.shape, (table, a.shape, b.shape)
        for col in a.columns:
            va, vb = a[col].to_numpy(), b[col].to_numpy()
            same = [(x == y) or (x != x and y != y) for x, y in zip(va, vb)]
            assert all(same), (table, col)
        print("  %-8s identical on the mesh and one device (%d rows)" % (
            table, len(a)))
    print("  detex wall: mesh %.2f s, one device %.2f s" % (t_mesh, t_one))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    opts = ap.parse_args(argv)
    n_cards = 4 if opts.four_cards else 1
    try:
        require_gpus(n_cards)
        cards = card_lines()
    except Exception as e:
        print("chip_smoke: %s" % e, file=sys.stderr)
        return 2
    import jax
    # exact 30 s templates: 3000 samples is not a multiple of the
    # trim-length ladder's 64-sample rung (subspace.TRIM_QUANTUM)
    os.environ["DETEX_TPU_TRIM_QUANTUM"] = "1"
    label = " / ".join(cards)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    cwd = os.getcwd()
    results = []

    def run(name, fn, *a, **kw):
        print("== %s" % name, flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*a, **kw)
            ok = True
        except Exception:
            traceback.print_exc()
            out, ok = None, False
        print("== %s: %s (%.1f s) [%s]" % (
            name, "ok" if ok else "FAILED", time.perf_counter() - t0,
            label), flush=True)
        results.append(ok)
        return out

    os.chdir(root)
    try:
        run("environment", phase_environment, cards)
        if opts.four_cards:
            run("four-cards", phase_four_cards, root, n_cards=n_cards)
        else:
            data = run("main-path", phase_main_path, root, label)
            run("ds-parity", phase_ds_parity)
            if data is None:
                data = synth_dataset(os.path.join(root, "day"), 1, 24)
            run("list-parity", phase_list_parity, *data, root)
            os.chdir(HERE)
            run("gpu-tests", phase_gpu_tests)
    finally:
        os.chdir(cwd)
    for ln in cards:
        print("card: %s" % ln)
    if not all(results):
        print("chip_smoke: %d of %d phases failed" % (
            results.count(False), len(results)), file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
