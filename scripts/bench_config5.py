"""
BASELINE config-5 miniature: a multi-station x large-template-bank
END-TO-END engine run — 5 stations x ~100
templates x ~4.5 days of 50 Hz continuous data through the full production
pipeline: createCluster -> createSubSpace -> attachPickTimes -> SVD ->
SubSpace.detex (subspaces + the ~per-station-100-detector singles bank,
histograms on, magnitudes on) -> detResults association.

Prints one JSON line with the end-to-end detex() wall time, the
station-days/s it implies, AND an attribution table: per-program XLA
compile counts/seconds (detex_tpu.compile_cache
.track_compiles), persistent-cache hits, and the profiling.py stage walls
— so compile vs launch vs host cost is measured, not asserted.

Run on the GPU (no platform forcing):

    python -u scripts/bench_config5.py [span_hours] [n_singles] [pf]

CONFIG5_PF / the third argument set the detection Pf (default 1e-12, the
reference default — construct.py:177); a realistic detection-dense run
uses e.g. 1e-9.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    span_hours = int(sys.argv[1]) if len(sys.argv) > 1 else 110
    n_singles = int(sys.argv[2]) if len(sys.argv) > 2 else 94
    pf = float(sys.argv[3] if len(sys.argv) > 3
               else os.environ.get("CONFIG5_PF", "1e-12"))
    # dtype='double' (reference default) re-verifies every triggered
    # chunk through the exact f64 host chain; 'single' is the production
    # device configuration (f32 device scan + device-windowed re-verify,
    # bit-identical to the engine's f32 exact chain —
    # tests/test_device_triggers.py)
    dtype = os.environ.get("CONFIG5_DTYPE", "double")

    import detex_tpu
    from detex_tpu import compile_cache, profiling
    from detex_tpu import results as _results
    from detex_tpu.data import fetcher as getdata
    from detex_tpu.data.synth import SynthCatalog

    compile_cache.track_compiles()

    wd = tempfile.mkdtemp(prefix="config5_")
    os.chdir(wd)
    print("workdir:", wd, flush=True)

    t_all = time.perf_counter()
    cat = SynthCatalog(n_sources=2, events_per_source=3,
                       n_singles=n_singles, n_stations=5, sr=50.0,
                       span_hours=span_hours, seed=11, noise=0.05)
    cat.add_hidden_events(n=3, mag=1.5, sources=[0, 1, 0])
    paths = cat.write_directories(wd, tb4=10, taft=60)
    n_templates = 2 * 3 + n_singles
    print("synth: 5 stations x %d templates x %d h (%.1f s)"
          % (n_templates, span_hours, time.perf_counter() - t_all),
          flush=True)

    def snap(label, t0):
        n, s, _ = compile_cache.compile_report()
        wall = time.perf_counter() - t0
        print("%s: %.1f s wall, %d compiles (%.1f s compile so far)"
              % (label, wall, n, s), flush=True)
        return wall, n, s

    t0 = time.perf_counter()
    clust = detex_tpu.createCluster(
        CCreq=0.5, fetch_arg=paths["eventDir"], filt=[1, 10, 2, True],
        stationKey=paths["stationKey"], templateKey=paths["templateKey"],
        trim=[10, 60], saveclust=False)
    t_cluster, nC1, sC1 = snap("cluster", t0)

    t0 = time.perf_counter()
    cfetch = getdata.DataFetcher("dir", directoryName=paths["conDir"])
    # Pf=1e-12 = the reference default (construct.py:177); CONFIG5_PF=1e-9
    # is the detection-dense stress configuration
    ss = detex_tpu.createSubSpace(Pf=pf, clust=clust, minEvents=2,
                                  dtype=dtype, conDatFetcher=cfetch)
    ss.attachPickTimes(pksFile=paths["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=4,
           useSingles=True, backupThreshold=0.25)
    t_build, nC2, sC2 = snap("subspace+svd+fas", t0)
    n_ss = sum(len(df) for df in ss.subspaces.values())
    n_sg = sum(len(df) for df in ss.singles.values())
    n_lens = {sta: sorted({int(r.SampleTrims["Endtime"] -
                               r.SampleTrims["Starttime"])
                           for _, r in df.iterrows() if r.SampleTrims})
              for grp in (ss.subspaces, ss.singles)
              for sta, df in grp.items()}
    print("built %d subspaces + %d singles across %d stations; "
          "template-length ladder per station: %s"
          % (n_ss, n_sg, len(ss.clusters.stakey),
             sorted(set(tuple(v) for v in n_lens.values()))), flush=True)

    db = os.path.join(wd, "SubSpace.db")
    t0 = time.perf_counter()
    ss.detex(subspaceDB=db, useSubSpaces=True, useSingles=True,
             estimateMags=True, calcHist=True, batchSize=16)
    t_detex, nC3, sC3 = snap("detex", t0)

    t0 = time.perf_counter()
    res = _results.detResults(
        requiredNumStations=3, veriBuffer=4, ssDB=db,
        templateKey=paths["templateKey"], stationKey=paths["stationKey"],
        veriFile=paths["veriFile"], fetch=cfetch)
    t_assoc = time.perf_counter() - t0
    print("results:", repr(res), flush=True)

    n_compiles, s_compiles, comp_rows = compile_cache.compile_report()
    stage_df = profiling.report()
    stages = {r["stage"]: [r["calls"], r["total_s"]]
              for r in stage_df.to_dict("records")}
    print("stage walls:\n%s" % stage_df.to_string(), flush=True)
    print("compiles (top 12):", flush=True)
    for name, cnt, secs in comp_rows[:12]:
        print("  %6.1fs x%-3d %s" % (secs, cnt, name), flush=True)
    print("cache:", compile_cache.CACHE_HITS, flush=True)

    vers = getattr(res, "Vers", None)
    n_verified = int(len(vers)) if vers is not None else 0
    dets = getattr(res, "Dets", None)
    n_dets = int(len(dets)) if dets is not None else 0
    station_days = 5 * span_hours / 24.0
    det_per_station = n_ss / max(len(ss.ssStations), 1) + \
        n_sg / max(len(ss.singStations), 1)
    print(json.dumps({
        "metric": "config-5 miniature: end-to-end detex() wall seconds "
                  "(5 stations x %d templates x %.1f station-days, "
                  "hist+mags on, Pf=%g, dtype=%s)"
                  % (n_templates, station_days, pf, dtype),
        "value": round(t_detex, 1),
        "unit": "s",
        "station_days_per_s": round(station_days / t_detex, 3),
        "detectors_per_station": round(det_per_station, 1),
        "stage_seconds": {"synth+cluster": round(t_cluster, 1),
                          "subspace+svd+fas": round(t_build, 1),
                          "detex": round(t_detex, 1),
                          "association": round(t_assoc, 1)},
        "attribution": {
            "xla_compiles": n_compiles,
            "xla_compile_seconds": s_compiles,
            "compile_seconds_by_phase": {
                "cluster": round(sC1, 1),
                "subspace+svd+fas": round(sC2 - sC1, 1),
                "detex": round(sC3 - sC2, 1)},
            "cache_hits": compile_cache.CACHE_HITS["hits"],
            "cache_saved_seconds": round(
                compile_cache.CACHE_HITS["saved_s"], 1),
            "stage_walls": stages,
            "top_compiles": [[n, c, s] for n, c, s in comp_rows[:8]],
        },
        "detections": n_dets,
        "verified": n_verified,
    }))


if __name__ == "__main__":
    main()
