"""
Headline benchmarks on an NVIDIA GPU, printed as ONE final JSON line.

Default invocation (``python bench.py``) runs every mode, each in its own
subprocess (the parent never imports JAX, so one process holds the card
at a time):

  - ``subspace`` (headline): station-days of continuous data scanned per
    second by the subspace detection scan (the production hot loop,
    reference _MPXDS detect.py:559-578) — a 10-event subspace (4 basis
    vectors), 30 s templates, 100 Hz 3-channel data, including on-device
    401-bin histogramming and trigger gating.
  - ``dense``: the same scan with planted detections in 3% of the chunks,
    through the engine's re-verify / STA-LTA / trigger / magnitude path.
  - ``network``: a 1000-template matched-filter bank via the overlap-save
    path.
  - ``cluster``: createCluster compute (220 events x 2 stations all-pairs
    CC) vs the reference's one published wall time (156 s).

The final JSON line is the headline subspace metric with the other results
embedded under ``"extras"``; every result carries the device it ran on
(platform, kind, count, card name and power limit). A mode that fails, or
a run without a GPU, exits non-zero.

vs_baseline: measured device rate divided by the rate of the reference-
equivalent float64 single-thread numpy core (ds_numpy, mirroring
detect.py:559-578) measured on the same host over the same workload. For
``cluster`` it is the reference's published 156 s over our wall time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# headline subspace-scan chunk length (hours); conDatDuration is a free
# parameter of the production engine
SUBSPACE_CHUNK_HOURS = float(os.environ.get("BENCH_CHUNK_HOURS", "2"))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_record():
    """The device a result was measured on; RuntimeError without a GPU."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise RuntimeError("bench.py measures on a GPU; JAX finds none (%s)"
                           % e)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(jax.devices()), "cards": cards}


def bench_cluster():
    """
    The reference's one published wall-time: createCluster over ~220
    events, 2 stations, 100 Hz, trim=[10,120] took 156 s on the author's
    desktop (BASELINE.md rows 1-2). This measures the equivalent compute —
    two stations' all-pairs CC/lag/subsample matrices (2 x 24,090 pairs of
    39,000-sample multiplexed traces) — on one GPU.
    """
    from detex_tpu.ops import xcorr

    N, L = 220, 39000  # 220 events, 130 s at 100 Hz x 3 channels
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, L)).astype(np.float32)
    # warmup at full shape (compile)
    xcorr.xcorr_all_pairs(X, 3)
    t0 = time.perf_counter()
    for s in range(2):  # 2 stations (distinct data)
        Xs = rng.standard_normal((N, L)).astype(np.float32)
        cc, lag, sub = xcorr.xcorr_all_pairs(Xs, 3)
    dt = time.perf_counter() - t0
    ref = 156.0  # seconds (clustering.md:771-777, 1413-1417)
    return {
        "metric": "createCluster compute (220 events x 2 stations, "
                  "all-pairs CC) wall seconds",
        "value": dt,
        "unit": "s",
        "vs_baseline": ref / dt,
    }


def bench_scan(mode="subspace"):
    import jax
    import jax.numpy as jnp
    from detex_tpu.ops import ds as dsops
    from detex_tpu.parallel import scan as pscan

    nc = 3
    sr = 100.0
    tmpl_sec = 30.0
    n = int(tmpl_sec * sr * nc)          # 9000
    rng = np.random.default_rng(0)
    if mode == "network":
        chunk_sec = 3600.0
        Lc = int(chunk_sec * sr * nc)    # 1,080,000
        # BASELINE config 5 analog: a 1000-template matched-filter bank
        # (one normalized template per detector) scanned per chunk via the
        # overlap-save spectra + template-blocked path
        S = 1000
        T = rng.standard_normal((S, n))
        U_list = [np.ascontiguousarray(
            (t / np.linalg.norm(t))[None, :]) for t in T]
        blk_env = os.environ.get("BENCH_BLK")
        bank = dsops.build_bank(U_list, nc, Lc,
                                block_fft=int(blk_env) if blk_env
                                else None)
        assert bank.get("os"), "1000-template bank should be overlap-save"
        thresholds = np.full(S, 0.99, np.float32)
        # chunks per launch
        B = int(os.environ.get("BENCH_B", "8"))
        iters = 8
        n_data = 8
    else:
        chunk_sec = 3600.0 * SUBSPACE_CHUNK_HOURS
        Lc = int(chunk_sec * sr * nc)
        D = 4                             # basis dims after energy capture
        A = rng.standard_normal((D, n))
        q, _ = np.linalg.qr(A.T)
        U = np.ascontiguousarray(q[:, :D].T)
        # the bank the production engine builds (build_bank's size rule;
        # BENCH_BLK forces an overlap-save block size)
        blk_env = os.environ.get("BENCH_BLK")
        bank = dsops.build_bank([U], nc, Lc,
                                block_fft=int(blk_env) if blk_env
                                else None)
        thresholds = np.full(1, 0.99, np.float32)
        # chunks per device call
        B = int(os.environ.get(
            "BENCH_B", str(max(1, int(round(512 / SUBSPACE_CHUNK_HOURS))))))
        iters = 2
        n_data = 4 if B < 256 else 2
    # distinct inputs per iteration
    Xs = [jax.random.normal(jax.random.PRNGKey(i), (B, Lc), jnp.float32)
          for i in range(n_data)]
    buff = int(20 * sr)

    # BENCH_HIST=0 drops the fused in-kernel histogram (profiling knob:
    # measures the hist share of the spec->DS kernel)
    calc_hist = os.environ.get("BENCH_HIST", "1") != "0"
    # the production engine scans summary-only (maxima + hist; triggered
    # chunks re-verify host-side — detect._materializeOne), so the
    # headline measures that configuration; BENCH_TRIGGERS=1 additionally
    # runs the on-device trigger extraction (serving-style scan)
    calc_trig = os.environ.get("BENCH_TRIGGERS", "0") == "1"

    def step(X):
        return pscan.scan_chunks(X, bank, thresholds, nc, buff, max_trig=16,
                                 calc_hist=calc_hist, calc_triggers=calc_trig)

    # warmup/compile, then steady state: best of 3 repeats, each step
    # synchronized with block_until_ready
    jax.block_until_ready(step(Xs[0]))
    dt = np.inf
    for rep in range(3):
        t0 = time.perf_counter()
        for i in range(iters):
            jax.block_until_ready(step(Xs[i % len(Xs)]))
        dt = min(dt, time.perf_counter() - t0)
    chunk_hours = chunk_sec / 3600.0
    station_days = iters * B * chunk_hours / 24.0
    ours = station_days / dt  # station-days per second

    # reference-equivalent numpy core, one hour-chunk (float64, single
    # thread); best of two runs to damp host noise
    ref_Lc = int(3600.0 * sr * nc)
    x64 = np.asarray(np.asarray(Xs[0][0])[:ref_Lc], np.float64)
    U_ref = U if mode != "network" else np.vstack(
        [u[0] for u in U_list[:4]])
    ref_dt = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        dsops.ds_numpy(x64, U_ref, nc)
        ref_dt = min(ref_dt, time.perf_counter() - t0)
    if mode == "network":
        # scale numpy cost from 4 to S templates (linear in detectors)
        ref_dt = ref_dt * (len(U_list) / U_ref.shape[0])
    ref_rate = (1.0 / 24.0) / ref_dt  # station-days/s of the numpy core

    desc = ("10-event subspace" if mode != "network"
            else "%d-template matched-filter bank" % len(thresholds))
    trig_desc = ("hist+on-device triggers" if calc_trig else
                 "hist+trigger gating, engine summary-only scan")
    out = {
        "metric": "station-days scanned/sec (%s, 100Hz 3ch, incl. "
                  "%s)" % (desc, trig_desc),
        "value": ours,
        "unit": "station-days/s",
        "vs_baseline": ours / ref_rate,
    }
    return out


def bench_scan_dense(trigger_rate=0.03):
    """
    Dense-detection engine-path bench: the quiet headline scans
    detection-free noise, so the post-trigger host path
    contributes nothing to it. Here ``trigger_rate`` of the chunks carry a
    planted subspace event well above threshold and every step runs the
    engine's materialize path on its triggered chunks — the batched
    re-verify (ops.ds.run_bank_rows_batch), STA/LTA, trigger extraction
    and CC^2-weighted magnitudes through the REAL engine code
    (detect._SSDetex._createCoeffArray on a minimal engine shell) — with
    the engine's 1-deep dispatch pipeline (batch k+1 dispatched before
    batch k materializes). Same bank/chunking/batch as the quiet headline,
    so value/quiet-value is the dense-load retention ratio.
    """
    import jax
    import jax.numpy as jnp
    from detex_tpu.detect import _SSDetex
    from detex_tpu.ops import ds as dsops
    from detex_tpu.parallel import scan as pscan

    nc = 3
    sr = 100.0
    n = int(30.0 * sr * nc)
    chunk_sec = 3600.0 * SUBSPACE_CHUNK_HOURS
    Lc = int(chunk_sec * sr * nc)
    rng = np.random.default_rng(0)
    D = 4
    A = rng.standard_normal((D, n))
    q, _ = np.linalg.qr(A.T)
    U = np.ascontiguousarray(q[:, :D].T)
    bank = dsops.build_bank([U], nc, Lc)
    th = 0.3  # far above the noise-DS tail (max noise DS ~ 0.004 here)
    thresholds = np.full(1, th, np.float32)
    B = int(os.environ.get(
        "BENCH_B", str(max(1, int(round(512 / SUBSPACE_CHUNK_HOURS))))))
    iters = 2
    n_data = 4 if B < 256 else 2   # device memory, as the quiet headline
    # host chunk arrays with planted events: amp c gives DS ~ c^2/(n+c^2)
    c = float(np.sqrt(n * 0.6 / 0.4))             # ~0.6 DS at the plant
    k_per_batch = max(1, int(round(trigger_rate * B)))
    Xh = []
    for i in range(n_data):
        Xi = rng.standard_normal((B, Lc)).astype(np.float32)
        for bi in rng.choice(B, size=k_per_batch, replace=False):
            w0 = int(rng.integers(1, Lc // nc - n // nc - 1)) * nc
            Xi[bi, w0:w0 + n] += (c * U[0]).astype(np.float32)
        Xh.append(Xi)
    Xs = [jnp.asarray(x) for x in Xh]
    buff = int(20 * sr)

    # minimal engine shell so the per-trigger path is the REAL engine code
    eng = object.__new__(_SSDetex)
    eng.trigCon = 0
    eng.fillZeros = False
    eng.estimateMags = True
    eng.dtype = "single"
    eng.issubspace = True
    eng.triggerLTATime = 5
    eng.triggerSTATime = 0
    WFs = np.stack([c * U[0] + 0.3 * rng.standard_normal(n)
                    for _ in range(4)]).astype(np.float64)
    det = {"SS0": dict(U=U, WFs=WFs, n=n,
                       mags=np.array([1.0, 1.2, 0.9, 1.1]),
                       events=["e%d" % i for i in range(4)],
                       offsets=np.zeros(4), WFU=(WFs @ U.T) @ U)}

    def step(X):
        # engine configuration: summary-only scan, triggers host-side
        return pscan.scan_chunks(X, bank, thresholds, nc, buff, max_trig=1,
                                 calc_triggers=False)

    use_dev_trig = os.environ.get("DETEX_TPU_DEVICE_TRIGGERS", "1") != "0"

    def materialize(out, ih):
        """detect._materializeOne's f32 path on one dispatched batch:
        device-windowed re-verify by default (STA/LTA + extraction in the
        bank program, per-trigger values only over the link), the full-row
        host chain with DETEX_TPU_DEVICE_TRIGGERS=0 — same gate as the
        engine."""
        hist, maxds, tidx, tval, tcnt = out
        m = np.asarray(maxds)             # completion barrier for the step
        trig_b = [bi for bi in range(B) if m[bi, 0] > th - 2e-5]
        mps = [Xh[ih][bi] for bi in trig_b]
        nrows = 0
        if use_dev_trig:
            # gather the triggered chunks from the device-resident batch
            # (the engine reuses the scan's uploaded batch the same way)
            sel = jnp.take(Xs[ih], jnp.asarray(trig_b, jnp.int32), axis=0)
            tout = dsops.run_bank_triggers_batch(
                mps, bank, nc, [[0]] * len(mps), [[th]] * len(mps),
                [sr] * len(mps), 5.0, 0.0, True,
                x_dev=sel, lens_dev=[Lc] * len(mps))
            for mp, td in zip(mps, tout):
                idx, ds_at, sl_at = td[0]
                Sar = eng._coeffRows(idx, ds_at, sl_at, "SS0", "TA.SYN",
                                     det, mp, nc, sr, 0.0)
                nrows += len(Sar)
        else:
            dsrows = dsops.run_bank_rows_batch(mps, bank, nc,
                                               [[0]] * len(mps))
            for mp, dsr in zip(mps, dsrows):
                dsvec = dsr[0]
                stalta = np.asarray(eng._dsStalta(dsvec, 5 * sr, 0))
                Sar = eng._createCoeffArray(dsvec, stalta, "SS0",
                                            {"SS0": th}, "TA.SYN", det, mp,
                                            nc, sr, 0.0)
                nrows += len(Sar)
        return len(trig_b), nrows

    # warmup/compile every path the timed loop hits (scan at B, re-verify
    # at the padded trigger-batch size, stalta, trigger extraction)
    out = step(Xs[0])
    materialize(out, 0)

    dt = np.inf
    ntrig = nrows = 0
    for rep in range(3):
        t0 = time.perf_counter()
        prev = None
        ntrig = nrows = 0
        for i in range(iters):
            out = step(Xs[i % n_data])
            if prev is not None:          # engine's 1-deep in-flight queue
                t, r = materialize(*prev)
                ntrig += t
                nrows += r
            prev = (out, i % n_data)
        t, r = materialize(*prev)
        ntrig += t
        nrows += r
        jax.block_until_ready(out)
        dt = min(dt, time.perf_counter() - t0)
    chunk_hours = chunk_sec / 3600.0
    station_days = iters * B * chunk_hours / 24.0
    ours = station_days / dt
    res = {
        "metric": "station-days scanned/sec (10-event subspace, "
                  "DENSE detections: %.0f%% of chunks trigger, full "
                  "engine re-verify/STA-LTA/triggers/mags path)"
                  % (100.0 * k_per_batch / B),
        "value": ours,
        "unit": "station-days/s",
        "trigger_chunk_pct": 100.0 * k_per_batch / B,
        "detections_per_run": nrows,
    }
    return res


MODES = {"subspace": lambda: bench_scan("subspace"),
         "network": lambda: bench_scan("network"),
         "dense": lambda: bench_scan_dense(),
         "cluster": lambda: bench_cluster()}


def main(mode=None):
    if mode in MODES:
        try:
            dev = device_record()
        except RuntimeError as e:
            _log(str(e))
            return 2
        res = MODES[mode]()
        res["device"] = dev
        print(json.dumps(res))
        return 0
    # default: all modes, ONE final JSON line (headline + extras). Each
    # mode runs in its OWN subprocess, sequentially: a process exit is the
    # only guaranteed release of device memory, and one process holds the
    # card at a time.
    def run_mode(m):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), m],
            capture_output=True, text=True, timeout=3600)
        if out.returncode != 0:
            raise RuntimeError("%s exited %d: %s" % (
                m, out.returncode, out.stderr.strip()[-400:]))
        for line in reversed(out.stdout.strip().splitlines()):
            try:
                return json.loads(line)
            except ValueError:
                continue
        raise RuntimeError("no JSON from %s: %s" % (
            m, out.stderr.strip()[-400:]))

    failed = 0
    _log("bench: subspace scan (headline, %gh chunks)..."
         % SUBSPACE_CHUNK_HOURS)
    try:
        head = run_mode("subspace")
        _log("bench: subspace = %s" % head["value"])
    except Exception as e:
        _log("bench: subspace FAILED: %r" % e)
        head = {"metric": "subspace", "error": repr(e)}
        failed += 1
    extras = []
    for m in ("dense", "network", "cluster"):
        _log("bench: %s..." % m)
        try:
            r = run_mode(m)
            _log("bench: %s = %s" % (m, r["value"]))
        except Exception as e:
            _log("bench: %s FAILED: %r" % (m, e))
            r = {"metric": m, "error": repr(e)}
            failed += 1
        extras.append(r)
    if "value" in head and "value" in extras[0]:
        extras[0]["pct_of_quiet"] = (100.0 * extras[0]["value"]
                                     / head["value"])
    head["extras"] = extras
    print(json.dumps(head))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
