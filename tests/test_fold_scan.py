"""Fold-batch OS scan route (parallel/scan.py): the whole chunk batch is
folded into each op instead of lax.map-ing the per-chunk pipeline. Must be
output-identical to the per-chunk route (which is itself gated against the
float64 oracle). Both routes are called directly: scan_chunks picks the
fold route for these banks, _per_chunk runs the same program arguments
through the per-chunk jit."""
import numpy as np
import pytest

from detex_tpu.ops import ds as dsops
from detex_tpu.parallel import scan as pscan


def _per_chunk(X, bank, th, nc, buff_samps, max_trig, valid_lens=None,
               calc_hist=True, calc_triggers=True, bins=None):
    """scan_chunks through the per-chunk lax.map route, whatever route
    it would pick itself."""
    fn, args, kw, route = pscan.scan_program(
        X, bank, th, nc, buff_samps, bins=bins, max_trig=max_trig,
        valid_lens=valid_lens, calc_hist=calc_hist,
        calc_triggers=calc_triggers)
    kw.pop("blk_fft", None)
    return pscan._scan_chunks_jit(*args, demux="os", nfft=bank["blk_fft"],
                                  **kw)


def _mk_bank(rng, nc=3, n_c=30, Lc=9000):
    n = n_c * nc
    U1 = rng.standard_normal((2, n))
    q, _ = np.linalg.qr(U1.T)
    U1 = np.ascontiguousarray(q[:, :2].T)
    U2 = rng.standard_normal((1, n))
    U2 = U2 / np.linalg.norm(U2)
    bank = dsops.build_bank([U1, U2], nc, Lc, prefer_os=True)
    assert bank.get("os")
    return bank, U1


def test_fold_scan_matches_per_chunk_path():
    rng = np.random.default_rng(3)
    nc, Lc = 3, 9000
    bank, U1 = _mk_bank(rng, nc=nc, Lc=Lc)
    th = np.array([0.25, 0.25], np.float32)
    B = 3
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    lens = [Lc, Lc - 600, Lc - 1200]
    for i, L in enumerate(lens):
        X[i, L:] = 0.0
    st = pscan._bank_statics(bank, nc)
    assert pscan._os_fold_route(bank, st, B, Lc, th)[0] == "fold"
    fold = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=8,
                             valid_lens=lens)
    base = _per_chunk(X, bank, th, nc, buff_samps=50, max_trig=8,
                      valid_lens=lens)
    hist_f, maxds_f, tidx_f, tval_f, tcnt_f = map(np.asarray, fold)
    hist_b, maxds_b, tidx_b, tval_b, tcnt_b = map(np.asarray, base)
    assert np.array_equal(hist_f, hist_b)
    assert np.allclose(maxds_f, maxds_b, atol=2e-5)
    assert np.array_equal(tidx_f, tidx_b)
    assert np.array_equal(tcnt_f, tcnt_b)
    m = tidx_f >= 0
    assert np.allclose(tval_f[m], tval_b[m], atol=2e-5)

    # and against the float64 oracle on the full chunk
    ds64 = dsops.ds_numpy(np.asarray(X[0], np.float64), U1, nc)
    assert abs(ds64.max() - maxds_f[0, 0]) < 2e-5


def test_fold_scan_calc_hist_off():
    rng = np.random.default_rng(4)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    th = np.array([0.25, 0.25], np.float32)
    X = rng.standard_normal((2, Lc)).astype(np.float32)
    hist, maxds, *_ = pscan.scan_chunks(X, bank, th, nc, buff_samps=50,
                                        max_trig=8, calc_hist=False)
    assert np.asarray(hist).sum() == 0
    assert np.isfinite(np.asarray(maxds)).all()


def test_fold_scan_sharded_matches_single():
    """Mesh-sharded fold scan (psum'd hist) == single-device fold scan."""
    from detex_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(7)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    th = np.array([0.25, 0.25], np.float32)
    B = 5   # odd: exercises mesh padding
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    lens = [Lc, Lc - 300, Lc, Lc - 900, Lc]
    for i, L in enumerate(lens):
        X[i, L:] = 0.0
    mesh = make_mesh()
    assert mesh.size > 1
    single = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=8,
                               valid_lens=lens)
    shard = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=8,
                              valid_lens=lens, mesh=mesh)
    for a, b in zip(single, shard):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.allclose(np.nan_to_num(a, nan=-9, neginf=-1e30),
                           np.nan_to_num(b, nan=-9, neginf=-1e30),
                           atol=2e-5)


def test_fold_scan_blocked_matches_per_chunk_path():
    """Template-blocked (network-path) fold: S > TEMPLATE_BLOCK banks fold
    the chunk batch and lax.map over template blocks; outputs must match
    the per-chunk lax.map path."""
    rng = np.random.default_rng(9)
    nc, n_c, Lc = 3, 30, 9000
    n = n_c * nc
    S = pscan.TEMPLATE_BLOCK + 8
    T = rng.standard_normal((S, n))
    U_list = [np.ascontiguousarray((t / np.linalg.norm(t))[None, :])
              for t in T]
    bank = dsops.build_bank(U_list, nc, Lc, prefer_os=True)
    assert bank.get("os")
    th = np.full(S, 0.3, np.float32)
    B = 4
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    lens = [Lc, Lc - 900, Lc - 300, Lc]
    for i, L in enumerate(lens):
        X[i, L:] = 0.0
    st = pscan._bank_statics(bank, nc)
    assert pscan._os_fold_route(bank, st, B, Lc, th)[0] == "blocked"
    fold = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=4,
                             valid_lens=lens)
    base = _per_chunk(X, bank, th, nc, buff_samps=50, max_trig=4,
                      valid_lens=lens)
    hist_f, maxds_f, tidx_f, tval_f, tcnt_f = map(np.asarray, fold)
    hist_b, maxds_b, tidx_b, tval_b, tcnt_b = map(np.asarray, base)
    assert hist_f.shape == hist_b.shape == (S, 400)
    assert np.array_equal(hist_f, hist_b)
    assert maxds_f.shape == maxds_b.shape == (B, S)
    assert np.allclose(maxds_f, maxds_b, atol=2e-5)
    assert np.array_equal(tidx_f, tidx_b)
    assert np.array_equal(tcnt_f, tcnt_b)


def test_finalize_os_fold_hist_matches_np():
    """The fold route's per-row histogram equals np.histogram over the
    valid DS samples (masked -inf positions excluded), the pad tail is
    masked and the pyramid holds the 128-sample block maxima."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    B = 2
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    nv = np.asarray(pscan._valid_lens(bank, nc, X, [Lc, Lc - 111]))
    F, a, power = dsops.os_prep_batch(jnp.asarray(X), bank["n_c"], nc,
                                      bank["blk_fft"])
    ds, pyr = dsops.os_block_scan_batch(
        F, a, power, bank["Ufd2"], bank["sum_u"], bank["d_mask"],
        bank["n_c"], nc, bank["blk_fft"], Lc // nc, nv)
    ds, pyr = np.asarray(ds), np.asarray(pyr)
    bins = jnp.asarray(pscan.DEFAULT_BINS, jnp.float32)
    hist = np.asarray(pscan._hist_rows(jnp.asarray(ds.reshape(B * 2, -1)),
                                       bins, True)).reshape(B, 2, -1)
    edges = np.asarray(bins, np.float64)
    for b in range(B):
        for s in range(2):
            v = ds[b, s, :nv[b]]
            want, _ = np.histogram(v, bins=edges)
            assert np.array_equal(hist[b, s], want)
            assert (ds[b, s, nv[b]:] == -np.inf).all()
            assert np.array_equal(pyr[b, s],
                                  ds[b, s].reshape(-1, 128).max(axis=1))


def test_finalize_os_fold_group_not_pow2_tile():
    """A pad_rows rung that is not a power of two (S=24) through the fold
    route: every detector row must match the per-chunk route."""
    rng = np.random.default_rng(9)
    nc, n_c, Lc = 3, 30, 9000
    T = rng.standard_normal((24, n_c * nc))
    U_list = [np.ascontiguousarray((t / np.linalg.norm(t))[None, :])
              for t in T]
    bank = dsops.build_bank(U_list, nc, Lc, prefer_os=True)
    assert bank["sum_u"].shape[0] == 24
    th = np.full(24, 0.3, np.float32)
    X = rng.standard_normal((2, Lc)).astype(np.float32)
    got = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=4)
    want = _per_chunk(X, bank, th, nc, buff_samps=50, max_trig=4)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


def test_run_bank_batch_fold_matches_map(monkeypatch):
    """run_bank_batch (FAS path) routes OS banks through the fold scan
    when it fits; values must match the per-chunk lax.map path (taken
    when it does not) on the valid region."""
    rng = np.random.default_rng(11)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    xs = [rng.standard_normal(Lc).astype(np.float32),
          rng.standard_normal(Lc - 600).astype(np.float32),
          rng.standard_normal(Lc - 1500).astype(np.float32)]
    got = dsops.run_bank_batch(xs, bank, nc)
    monkeypatch.setattr(dsops, "hbm_budget", lambda device=None: 0)
    want = dsops.run_bank_batch(xs, bank, nc)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 2e-5
        assert np.isfinite(g).all()


def test_sharded_raw_os_matches_single_device():
    """devicePrep + mesh + overlap-save bank: scan_chunks_raw_sharded now
    runs prep_multiplex_batch INSIDE the shard body and folds each
    device's chunk shard (round-3 leftover: this config used to refuse OS
    banks and regress to full-length spectra). Outputs must match the
    single-device split-prep route, including an odd batch (mesh padding)
    and a ragged chunk."""
    import jax.numpy as jnp
    from detex_tpu.parallel import mesh as pmesh
    rng = np.random.default_rng(9)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    nfftp = 2 ** int(Lc // nc + bank["n_c"]).bit_length()
    H = jnp.ones(nfftp // 2 + 1, jnp.float32)
    B, L_raw = 7, Lc // nc
    Xc = rng.standard_normal((B, nc, L_raw)).astype(np.float32)
    lens = np.full(B, L_raw, np.int32)
    lens[2] = L_raw - 500          # ragged chunk
    for b in range(B):
        Xc[b, :, lens[b]:] = 0.0
    th = np.array([0.2, 0.2], np.float32)
    mesh = pmesh.make_mesh(8)
    got = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                max_trig=8, mesh=mesh)
    want = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                 max_trig=8)
    hist_g, maxds_g, tidx_g, tval_g, tcnt_g = map(np.asarray, got)
    hist_w, maxds_w, tidx_w, tval_w, tcnt_w = map(np.asarray, want)
    assert maxds_g.shape == maxds_w.shape == (B, 2)
    assert hist_g.sum() == hist_w.sum()
    assert np.abs(hist_g - hist_w).sum() <= 2      # f32 bin-edge jitter
    assert np.allclose(maxds_g, maxds_w, atol=2e-5)
    assert np.array_equal(tcnt_g, tcnt_w)
    assert np.array_equal(tidx_g, tidx_w)
    m = tidx_g >= 0
    assert np.allclose(tval_g[m], tval_w[m], atol=2e-5, equal_nan=True)


def test_sharded_raw_os_fallback_nonuniform_bins(monkeypatch):
    """When the folded intermediate does not fit the device budget, the
    sharded devicePrep OS path takes its per-chunk branch
    (_sharded_scan_raw_os_fn with route None) and must still match the
    single-device route, with non-uniform histogram bins."""
    import jax.numpy as jnp
    from detex_tpu.parallel import mesh as pmesh
    monkeypatch.setattr(dsops, "hbm_budget", lambda device=None: 0)
    rng = np.random.default_rng(13)
    nc, Lc = 3, 9000
    bank, _ = _mk_bank(rng, nc=nc, Lc=Lc)
    nfftp = 2 ** int(Lc // nc + bank["n_c"]).bit_length()
    H = jnp.ones(nfftp // 2 + 1, jnp.float32)
    B, L_raw = 4, Lc // nc
    Xc = rng.standard_normal((B, nc, L_raw)).astype(np.float32)
    lens = np.full(B, L_raw, np.int32)
    th = np.array([0.2, 0.2], np.float32)
    bins = np.concatenate([[0.0], np.geomspace(1e-3, 1.0, 40)])  # ragged
    mesh = pmesh.make_mesh(8)
    st = pscan._bank_statics(bank, nc)
    assert pscan._os_fold_route(bank, st, 1, Lc, th)[0] is None
    got = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                max_trig=8, bins=bins, mesh=mesh)
    want = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                 max_trig=8, bins=bins)
    hist_g, maxds_g, tidx_g, _, tcnt_g = map(np.asarray, got)
    hist_w, maxds_w, tidx_w, _, tcnt_w = map(np.asarray, want)
    assert hist_g.shape == (2, 40)
    assert np.abs(hist_g.astype(np.int64) - hist_w.astype(np.int64)
                  ).sum() <= 2
    assert np.allclose(maxds_g, maxds_w, atol=2e-5)
    assert np.array_equal(tcnt_g, tcnt_w)
    assert np.array_equal(tidx_g, tidx_w)


def test_sharded_blocked_fold_matches_single_device():
    """S > TEMPLATE_BLOCK on a mesh: scan_chunks_sharded must take the
    same template-blocked fold route as the single-device path (review
    round 3c: the mesh path used to silently fall back to the per-chunk
    lax.map pipeline), and the outputs must match."""
    from detex_tpu.parallel import mesh as pmesh
    rng = np.random.default_rng(21)
    nc, n_c, Lc = 3, 30, 9000
    n = n_c * nc
    S = pscan.TEMPLATE_BLOCK + 8
    T = rng.standard_normal((S, n))
    U_list = [np.ascontiguousarray((t / np.linalg.norm(t))[None, :])
              for t in T]
    bank = dsops.build_bank(U_list, nc, Lc, prefer_os=True)
    th = np.full(S, 0.3, np.float32)
    B = 8
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    st = pscan._bank_statics(bank, nc)
    route, _, _ = pscan._os_fold_route(bank, st, 1, Lc, th)
    assert route == "blocked"
    mesh = pmesh.make_mesh(8)
    got = pscan.scan_chunks_sharded(mesh, X, bank, th, nc, buff_samps=50,
                                    max_trig=4)
    want = pscan.scan_chunks(X, bank, th, nc, buff_samps=50, max_trig=4)
    hist_g, maxds_g, tidx_g, tval_g, tcnt_g = map(np.asarray, got)
    hist_w, maxds_w, tidx_w, tval_w, tcnt_w = map(np.asarray, want)
    assert hist_g.shape == (S, 400)
    assert np.abs(hist_g.astype(np.int64) - hist_w.astype(np.int64)
                  ).sum() <= 4
    assert np.allclose(maxds_g, maxds_w, atol=2e-5)
    assert np.array_equal(tcnt_g, tcnt_w)
    assert np.array_equal(tidx_g, tidx_w)
    m = tidx_g >= 0
    assert np.allclose(tval_g[m], tval_w[m], atol=2e-5)


def test_sharded_raw_os_blocked_matches_single_device():
    """devicePrep + mesh + S > TEMPLATE_BLOCK: the sharded raw path must
    run the template-blocked fold inside the shard body (route 'blocked'
    in _sharded_scan_raw_os_fn) and match the single-device route."""
    import jax.numpy as jnp
    from detex_tpu.parallel import mesh as pmesh
    rng = np.random.default_rng(23)
    nc, n_c, Lc = 3, 30, 9000
    n = n_c * nc
    S = pscan.TEMPLATE_BLOCK + 8
    T = rng.standard_normal((S, n))
    U_list = [np.ascontiguousarray((t / np.linalg.norm(t))[None, :])
              for t in T]
    bank = dsops.build_bank(U_list, nc, Lc, prefer_os=True)
    nfftp = 2 ** int(Lc // nc + bank["n_c"]).bit_length()
    H = jnp.ones(nfftp // 2 + 1, jnp.float32)
    B, L_raw = 8, Lc // nc
    Xc = rng.standard_normal((B, nc, L_raw)).astype(np.float32)
    lens = np.full(B, L_raw, np.int32)
    lens[1] = L_raw - 300
    Xc[1, :, lens[1]:] = 0.0
    th = np.full(S, 0.3, np.float32)
    mesh = pmesh.make_mesh(8)
    got = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                max_trig=4, mesh=mesh)
    want = pscan.scan_chunks_raw(Xc, lens, H, bank, th, nc, buff_samps=50,
                                 max_trig=4)
    hist_g, maxds_g, tidx_g, tval_g, tcnt_g = map(np.asarray, got)
    hist_w, maxds_w, tidx_w, tval_w, tcnt_w = map(np.asarray, want)
    assert np.abs(hist_g.astype(np.int64) - hist_w.astype(np.int64)
                  ).sum() <= 4
    assert np.allclose(maxds_g, maxds_w, atol=2e-5)
    assert np.array_equal(tcnt_g, tcnt_w)
    assert np.array_equal(tidx_g, tidx_w)
    m = tidx_g >= 0
    assert np.allclose(tval_g[m], tval_w[m], atol=2e-5)


def test_os_fold_route_non_os_bank():
    """Non-overlap-save banks fall through to the per-chunk route with
    blocked arrays/thresholds — callers need no demux guard."""
    rng = np.random.default_rng(2)
    nc, Lc = 3, 9000
    n = 30 * nc
    U = rng.standard_normal((1, n))
    U = U / np.linalg.norm(U)
    bank = dsops.build_bank([U], nc, Lc, block_fft=0)   # force full-length
    assert not bank.get("os")
    st = pscan._bank_statics(bank, nc)
    th = np.array([0.3], np.float32)
    route, arrs, thd = pscan._os_fold_route(bank, st, 4, Lc, th)
    assert route is None
    assert len(arrs) == 3


def test_route_counter_records_routes():
    """Every scan entry point records its kernel route in the public
    counter."""
    rng = np.random.default_rng(11)
    bank, _ = _mk_bank(rng)
    X = rng.standard_normal((4, bank["pad_len"])).astype(np.float32)
    th = np.full(2, 0.9, np.float32)
    before = dict(pscan.ROUTE_COUNTS)
    pscan.scan_chunks(X, bank, th, 3, buff_samps=10, max_trig=4)
    grew = {k: v for k, v in pscan.ROUTE_COUNTS.items()
            if v > before.get(k, 0)}
    assert len(grew) == 1
    name = next(iter(grew))
    assert name == "fold"


def test_summary_only_scan_matches():
    """calc_triggers=False (the engine's summary-only scan) must reproduce
    hist and maxds of the full scan exactly, with zero-capacity trigger
    outputs."""
    rng = np.random.default_rng(5)
    bank, _ = _mk_bank(rng)
    X = rng.standard_normal((8, bank["pad_len"])).astype(np.float32)
    th = np.full(2, 0.9, np.float32)
    full = pscan.scan_chunks(X, bank, th, 3, buff_samps=10, max_trig=4)
    summ = pscan.scan_chunks(X, bank, th, 3, buff_samps=10, max_trig=4,
                             calc_triggers=False)
    np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(summ[0]))
    np.testing.assert_array_equal(np.asarray(full[1]), np.asarray(summ[1]))
    assert np.asarray(summ[2]).shape[-1] == 0
    assert np.asarray(summ[3]).shape[-1] == 0
    assert np.asarray(summ[4]).shape == np.asarray(full[4]).shape


def test_summary_only_scan_sharded_matches():
    """Sharded summary-only scan: psum'd hist + maxds identical to the
    sharded full scan."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    from detex_tpu.parallel.mesh import make_mesh
    mesh = make_mesh()
    rng = np.random.default_rng(6)
    bank, _ = _mk_bank(rng)
    B = 2 * mesh.size
    X = rng.standard_normal((B, bank["pad_len"])).astype(np.float32)
    th = np.full(2, 0.9, np.float32)
    full = pscan.scan_chunks_sharded(mesh, X, bank, th, 3, buff_samps=10,
                                     max_trig=4)
    summ = pscan.scan_chunks_sharded(mesh, X, bank, th, 3, buff_samps=10,
                                     max_trig=4, calc_triggers=False)
    np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(summ[0]))
    np.testing.assert_array_equal(np.asarray(full[1]), np.asarray(summ[1]))
    assert np.asarray(summ[2]).shape[-1] == 0
