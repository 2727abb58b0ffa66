"""Shape canonicalization: trim-length quantization, bank row/basis-dim
padding ladders, power-of-two batch padding — the machinery that bounds
XLA compile counts on the end-to-end pipeline — plus the persistent
compile-cache placement."""
import os
import subprocess
import sys

import numpy as np
import pytest

from detex_tpu import subspace as _sub
from detex_tpu.ops import ds as dsops


# ---------------------------------------------------------------------------
# _quantize_trims
# ---------------------------------------------------------------------------

def _q(d1, Nc, max_len=None, quantum=64):
    old = _sub.TRIM_QUANTUM
    _sub.TRIM_QUANTUM = quantum
    try:
        return dict(_sub._quantize_trims(dict(d1), Nc, max_len=max_len))
    finally:
        _sub.TRIM_QUANTUM = old


def test_quantize_rounds_up():
    d = _q({"Starttime": 30, "Endtime": 30 + 999 * 3}, 3)
    assert d["Starttime"] == 30
    ln = d["Endtime"] - d["Starttime"]
    assert ln == 1024 * 3               # 999 -> 1024 per-channel samples
    assert d["Starttime"] % 3 == 0 and d["Endtime"] % 3 == 0


def test_quantize_noop_when_aligned():
    d = {"Starttime": 0, "Endtime": 128 * 3}
    assert _q(d, 3) == d


def test_quantize_shifts_start_at_data_end():
    # window ends at the data boundary: quantized length must shift start
    max_len = 2000 * 3
    d = _q({"Starttime": 1500 * 3, "Endtime": 1999 * 3}, 3, max_len=max_len)
    ln = d["Endtime"] - d["Starttime"]
    assert ln == 512 * 3
    assert d["Endtime"] <= max_len
    assert d["Starttime"] % 3 == 0 and d["Starttime"] >= 0


def test_quantize_extends_within_data():
    # 190 -> 192 per-channel samples when the data allows it
    d = _q({"Starttime": 0, "Endtime": 190 * 3}, 3, max_len=200 * 3)
    assert d["Endtime"] - d["Starttime"] == 192 * 3


def test_quantize_shrinks_when_window_cannot_fit():
    # data barely longer than the window: round down to the lower rung
    d = _q({"Starttime": 0, "Endtime": 190 * 3}, 3, max_len=191 * 3)
    assert d["Endtime"] - d["Starttime"] == 128 * 3
    # below one quantum: unchanged
    d2 = _q({"Starttime": 0, "Endtime": 50 * 3}, 3, max_len=60 * 3)
    assert d2["Endtime"] - d2["Starttime"] == 50 * 3


def test_quantize_disabled_at_unit_quantum():
    d = {"Starttime": 3, "Endtime": 3 + 997 * 3, "P": 12.0}
    assert _q(d, 3, quantum=1) == d


def test_quantize_collapses_ladder():
    # the network failure mode: ~100 detectors whose pick-derived lengths
    # differ by a few samples must land on ONE rung
    rng = np.random.default_rng(0)
    lens = {(_q({"Starttime": 0, "Endtime": int(3 * (1000 + k))}, 3)
             ["Endtime"]) for k in rng.integers(-30, 30, size=100)}
    assert len(lens) <= 2      # O(1) rungs (boundary-straddling gives 2)
    # pick jitter well inside one quantum -> exactly one rung
    lens = {(_q({"Starttime": 0, "Endtime": int(3 * (1000 + k))}, 3)
             ["Endtime"]) for k in rng.integers(-5, 5, size=100)}
    assert len(lens) == 1


# ---------------------------------------------------------------------------
# pad_rows / pad_dims ladders
# ---------------------------------------------------------------------------

def test_pad_ladders(monkeypatch):
    assert [dsops.pad_rows(s) for s in (1, 8, 9, 17, 94, 458, 1000)] == \
        [8, 8, 16, 24, 96, 512, 1024]
    assert [dsops.pad_dims(d) for d in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    monkeypatch.setenv("DETEX_TPU_PAD_BANKS", "0")
    assert dsops.pad_rows(94) == 94 and dsops.pad_dims(3) == 3


# ---------------------------------------------------------------------------
# padded banks compute identical DS on the real rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefer_os", [False, True])
def test_padded_bank_parity(prefer_os):
    rng = np.random.default_rng(1)
    nc, n, Lc = 3, 384, 3 * 4096
    U_list = []
    for d in (1, 2, 3):
        A = rng.standard_normal((d, n))
        q_, _ = np.linalg.qr(A.T)
        U_list.append(np.ascontiguousarray(q_[:, :d].T))
    x = rng.standard_normal(Lc).astype(np.float32)
    plain = dsops.build_bank(U_list, nc, Lc, prefer_os=prefer_os)
    padded = dsops.build_bank(U_list, nc, Lc, prefer_os=prefer_os,
                              pad_S=8, min_dmax=4)
    assert padded["sum_u"].shape == (8, 4)
    out_p = dsops.run_bank(x, plain, nc)
    out_q = dsops.run_bank(x, padded, nc)
    assert out_q.shape[0] == 8
    np.testing.assert_allclose(out_q[:3], out_p, rtol=0, atol=2e-5)
    # pad rows are identically zero DS
    assert float(np.abs(out_q[3:]).max()) == 0.0


def test_run_bank_batch_pads_to_pow2():
    rng = np.random.default_rng(2)
    nc, n, Lc = 3, 384, 3 * 4096
    A = rng.standard_normal((2, n))
    q_, _ = np.linalg.qr(A.T)
    U = np.ascontiguousarray(q_[:, :2].T)
    bank = dsops.build_bank([U], nc, Lc)
    xs = [rng.standard_normal(Lc - 7 * i).astype(np.float32)
          for i in range(3)]          # 3 ragged chunks -> padded batch of 4
    outs = dsops.run_bank_batch(xs, bank, nc)
    assert len(outs) == 3
    for x, o in zip(xs, outs):
        ref = dsops.run_bank(x, bank, nc)
        np.testing.assert_allclose(o, ref, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

def test_compile_cache_enabled():
    from jax._src import config as _jcfg
    from detex_tpu import compile_cache
    # detex_tpu import already called enable(): a cache dir is configured
    path = compile_cache.enable()
    assert path and _jcfg.compilation_cache_dir.value == path


def _cache_dir_in_fresh_process(**env):
    """jax's configured cache dir after ``import detex_tpu`` in a fresh
    process with ``env`` applied (None values are removed)."""
    e = dict(os.environ)
    for k, v in env.items():
        if v is None:
            e.pop(k, None)
        else:
            e[k] = v
    code = ("import detex_tpu; from jax._src import config as c; "
            "print(c.compilation_cache_dir.value)")
    out = subprocess.run([sys.executable, "-c", code], env=e, text=True,
                         capture_output=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("case", ["env", "default", "disabled"])
def test_compile_cache_placement(tmp_path, case):
    from detex_tpu import compile_cache
    if case == "env":
        # the variable is honoured and nothing else is set in code
        want = str(tmp_path / "cc")
        got = _cache_dir_in_fresh_process(JAX_COMPILATION_CACHE_DIR=want,
                                          DETEX_TPU_COMPILE_CACHE=None)
    elif case == "default":
        # without it the cache lives inside the checkout
        want = compile_cache.DEFAULT_CACHE_DIR
        got = _cache_dir_in_fresh_process(JAX_COMPILATION_CACHE_DIR=None,
                                          DETEX_TPU_COMPILE_CACHE=None)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert want == os.path.join(root, ".jaxcache")
    else:
        want = "None"
        got = _cache_dir_in_fresh_process(JAX_COMPILATION_CACHE_DIR=None,
                                          DETEX_TPU_COMPILE_CACHE="0")
    assert got == want


def test_track_compiles_counts():
    import jax
    import jax.numpy as jnp
    from detex_tpu import compile_cache
    compile_cache.track_compiles()
    base = sum(v[0] for v in compile_cache.COMPILES.values())

    @jax.jit
    def f(x):
        return jnp.tanh(x) * 3.30000111    # unique constant -> fresh program

    f(jnp.ones(17)).block_until_ready()
    assert sum(v[0] for v in compile_cache.COMPILES.values()) > base
