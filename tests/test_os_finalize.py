"""The plain-XLA overlap-save DS route (ops/ds.py) and what surrounds it:
the finalize against the float64 reference at the block geometries the
scan uses, the pad mask and trigger pyramid, the histogram binning, the
precision every float32 contraction states, the device-memory budget and
the route choice it drives."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detex_tpu.ops import ds as dsops
from detex_tpu.parallel import scan as pscan


def _bases(rng, S, D, n, masked=0):
    """S orthonormal [D, n] bases; the last ``masked`` banks get D-1 rows
    (their final basis slot is a masked zero slot in a Dmax=D bank)."""
    out = []
    for s in range(S):
        d = D - 1 if (s >= S - masked and D > 1) else D
        out.append(np.linalg.qr(rng.standard_normal((n, d)))[0].T)
    return out


# ---------------------------------------------------------------------------
# finalize: numpy trim-then-finalize at the old kernel-test geometries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,D,m,blk,n_c", [(4, 1, 3, 512, 100),
                                           (2, 3, 2, 256, 33),
                                           (1, 2, 4, 1024, 257)])
def test_os_finalize_matches_numpy(rng, S, D, m, blk, n_c):
    """_os_ds's finalize on given spectra == numpy inverse FFT, head trim,
    mean term, sum of squares and power divide (with a masked slot)."""
    head = -(-(n_c - 1) // 128) * 128      # aligned discard head
    W = blk - head
    L_c = m * W + n_c - 1 - int(rng.integers(0, W))   # ragged last block
    out_len = L_c - n_c + 1
    R = blk // 2 + 1
    F = (rng.standard_normal((1, 1, m, R)) +
         1j * rng.standard_normal((1, 1, m, R))).astype(np.complex64)
    U = (rng.standard_normal((S, D, 1, R)) +
         1j * rng.standard_normal((S, D, 1, R))).astype(np.complex64)
    a = (rng.standard_normal((1, out_len)) * 0.01).astype(np.float32)
    power = (np.abs(rng.standard_normal((1, out_len))) + 0.5
             ).astype(np.float32)
    sum_u = rng.standard_normal((S, D)).astype(np.float32)
    mask = np.ones((S, D), bool)
    mask[0, -1] = D == 1                   # a masked slot where D > 1
    got = np.asarray(dsops._os_ds(F, a, power, U, sum_u, mask, n_c, blk,
                                  L_c))[0, :, :out_len]
    cb = np.fft.irfft(U.astype(np.complex128) * F[0, 0][None, None],
                      blk, axis=-1)                    # [S, D, m, blk]
    cc = cb[..., head:head + W].reshape(S, D, m * W)[..., :out_len]
    y = (cc - sum_u[..., None] * a) * mask[..., None]
    want = (y ** 2).sum(axis=1) / power
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# fold route (all chunks folded into each op) against ds_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,D,n_c,masked,blk", [
    (1, 4, 100, 0, None),      # one subspace, natural block
    (3, 2, 33, 1, 256),        # ragged D (masked slot), tiny block
    (2, 3, 257, 0, 1024),      # n_c just past a 128 multiple
    (8, 1, 30, 0, None),       # single-vector templates
    (24, 1, 30, 0, 512),       # non-power-of-two detector rung
    (5, 3, 64, 2, 512),        # odd S, two masked slots
])
def test_fold_route_matches_ds_numpy(S, D, n_c, masked, blk):
    rng = np.random.default_rng(S * 100 + n_c)
    nc, B, Lc = 3, 2, 3 * 3000
    U = _bases(rng, S, D, n_c * nc, masked)
    bank = dsops.build_bank(U, nc, Lc, prefer_os=True, block_fft=blk)
    assert bank.get("os")
    X = rng.standard_normal((B, Lc))
    lens = [Lc, Lc - 99]
    nv = pscan._valid_lens(bank, nc, X, lens)
    F, a, power = dsops.os_prep_batch(jnp.asarray(X, jnp.float32),
                                      bank["n_c"], nc, bank["blk_fft"])
    ds, pyr = dsops.os_block_scan_batch(
        F, a, power, bank["Ufd2"], bank["sum_u"], bank["d_mask"],
        bank["n_c"], nc, bank["blk_fft"], Lc // nc, nv)
    ds = np.asarray(ds)
    for b in range(B):
        x = X[b, :lens[b]]
        for s in range(S):
            want = dsops.ds_numpy(x, U[s], nc)
            assert len(want) == nv[b]
            np.testing.assert_allclose(ds[b, s, :nv[b]], want, rtol=0,
                                       atol=2e-5)
            assert (ds[b, s, nv[b]:] == -np.inf).all()


# ---------------------------------------------------------------------------
# per-chunk OS route against ds_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,D,n_c,blk", [(1, 4, 100, None), (3, 2, 33, 256),
                                         (2, 1, 257, 1024),
                                         (4, 3, 50, 512)])
def test_per_chunk_os_matches_ds_numpy(S, D, n_c, blk):
    rng = np.random.default_rng(n_c)
    nc, Lc = 3, 3 * 2800
    U = _bases(rng, S, D, n_c * nc)
    bank = dsops.build_bank(U, nc, Lc, prefer_os=True, block_fft=blk)
    x = rng.standard_normal(Lc)
    got = dsops.run_bank(x, bank, nc)
    for s in range(S):
        np.testing.assert_allclose(got[s], dsops.ds_numpy(x, U[s], nc),
                                   rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# pad mask + trigger pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nv", [512, 300, 0])
def test_mask_pyramid(rng, nv):
    ds = rng.standard_normal((3, 512)).astype(np.float32)
    got, pyr = map(np.asarray, dsops._mask_pyramid(jnp.asarray(ds), nv))
    want = np.where(np.arange(512) < nv, ds, -np.inf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pyr, want.reshape(3, 4, 128).max(-1))


# ---------------------------------------------------------------------------
# histogram binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,L", [(3, 5000), (8, 2049), (1, 100)])
def test_hist_counts_matches_np(rng, S, L):
    ds = ((rng.integers(-40, 440, size=(S, L)) +
           rng.uniform(0.1, 0.9, size=(S, L))) / 400.0).astype(np.float32)
    ds[0, :5] = [0.0, 1.0, -np.inf, np.inf, 0.5]   # edges + out-of-range
    bins = jnp.asarray(pscan.DEFAULT_BINS, jnp.float32)
    got = np.asarray(pscan._hist_rows(jnp.asarray(ds), bins, True))
    edges = np.asarray(bins, np.float64)
    for s in range(S):
        want, _ = np.histogram(ds[s], bins=edges)
        np.testing.assert_array_equal(got[s], want)


def test_hist_counts_nonuniform_bins(rng):
    bins = np.concatenate([[0.0], np.geomspace(1e-3, 1.0, 40)])
    ds = rng.uniform(-0.1, 1.1, size=(2, 3000)).astype(np.float32)
    got = np.asarray(pscan._hist_rows(jnp.asarray(ds),
                                      jnp.asarray(bins, jnp.float32), True))
    b32 = np.asarray(bins, np.float32).astype(np.float64)
    for s in range(2):
        np.testing.assert_array_equal(got[s], np.histogram(ds[s], b32)[0])


def test_hist_rows_off_is_zeros(rng):
    ds = jnp.asarray(rng.random((4, 100)), jnp.float32)
    got = pscan._hist_rows(ds, jnp.zeros(11), False)
    assert got.shape == (4, 10) and int(jnp.abs(got).sum()) == 0


# ---------------------------------------------------------------------------
# FFT-based OS bank and all-pairs xcorr at a larger block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk", [1024, 2048])
def test_os_bank_fft_matches_oracle(rng, blk):
    nc, n, Lc = 3, 510, 3 * (1 << 12)
    T = rng.standard_normal((4, n))
    U_list = [np.ascontiguousarray((t / np.linalg.norm(t))[None, :])
              for t in T]
    bank = dsops.build_bank(U_list, nc, Lc, block_fft=blk)
    assert bank.get("os") and bank["blk_fft"] == blk
    x = rng.standard_normal(Lc).astype(np.float32)
    got = dsops.run_bank(x, bank, nc)
    for i, u in enumerate(U_list):
        assert np.abs(got[i] - dsops.ds_numpy(x, u, nc)).max() < 2e-5


def test_xcorr_pairs_fft_matches_pairwise(rng):
    """All-pairs xcorr (one batched inverse FFT per pair batch) matches
    the pairwise ccx2 kernel."""
    from detex_tpu.ops import xcorr
    N, nc, n = 6, 3, 306
    X = rng.standard_normal((N, n)).astype(np.float32)
    cc, lag, _ = xcorr.xcorr_all_pairs(X, nc)
    for i, j in [(0, 1), (2, 5), (3, 4)]:
        c1, l1, _ = xcorr.ccx2(X[i], X[j], nc)
        assert abs(float(cc[i, j]) - float(c1)) < 2e-5
        assert int(lag[i, j]) == int(l1)


# ---------------------------------------------------------------------------
# every float32 / complex64 contraction on the DS path states HIGHEST
# ---------------------------------------------------------------------------

def _dot_precisions(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert lines, "no dot_general in the lowered program"
    return ["precision = [HIGHEST, HIGHEST]" in ln for ln in lines]


def _demux_bank(os_bank):
    rng = np.random.default_rng(0)
    U = [np.linalg.qr(rng.standard_normal((90, 2)))[0].T]
    return dsops.build_bank(U, 3, 3 * 2000, prefer_os=os_bank)


def _pinned_ops():
    from detex_tpu.ops import prep
    demux, osb = _demux_bank(False), _demux_bank(True)
    x = jnp.ones(3 * 2000, jnp.float32)
    X = jnp.ones((2, 3 * 2000), jnp.float32)
    L_c = 2000
    return {
        "ds_bank_demux": (lambda v: dsops.ds_bank_demux(
            v, demux["Ufd2"], demux["sum_u"], demux["d_mask"], 30, 3,
            demux["nfft2"]), (x,)),
        "os_block": (lambda v: dsops.ds_bank_demux_os(
            v, osb["Ufd2"], osb["sum_u"], osb["d_mask"], 30, 3,
            osb["blk_fft"]), (x,)),
        "os_block_scan_batch": (lambda V: dsops.os_block_scan_batch(
            *dsops.os_prep_batch(V, 30, 3, osb["blk_fft"]), osb["Ufd2"],
            osb["sum_u"], osb["d_mask"], 30, 3, osb["blk_fft"], L_c,
            jnp.array([100, 100])), (X,)),
        "ds_bank_demux_raw": (lambda v: prep.ds_bank_demux_raw(
            v.reshape(3, -1), 2000, jnp.ones(demux["nfft2"] // 2 + 1),
            demux["Ufd2"], demux["sum_u"], demux["d_mask"], 30, 3,
            demux["nfft2"]), (x,)),
    }


@pytest.mark.parametrize("op", ["ds_bank_demux", "os_block",
                                "os_block_scan_batch", "ds_bank_demux_raw"])
def test_ds_path_contractions_are_highest(op):
    fn, args = _pinned_ops()[op]
    assert all(_dot_precisions(fn, *args))


def test_frac_energy_projection_is_highest(monkeypatch):
    """svd.frac_energy's float32 projection states HIGHEST (checked on
    the matmul it issues)."""
    from detex_tpu.ops import svd
    seen = []
    real = jnp.matmul

    def spy(a, b, precision=None, **kw):
        seen.append(precision)
        return real(a, b, precision=precision, **kw)

    monkeypatch.setattr(svd.jnp, "matmul", spy)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((5, 40))
    U = np.linalg.svd(A.T, full_matrices=False)[0]
    cum = svd.frac_energy(U, A, dtype="single")
    assert seen == [jax.lax.Precision.HIGHEST]
    np.testing.assert_allclose(cum[:, -1], 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# device-memory budget and the route it drives
# ---------------------------------------------------------------------------

class _FakeDevice(object):
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, 6 << 30),
    ({"bytes_in_use": 0}, 2 << 30),
    (None, 2 << 30),
    (RuntimeError("no stats"), 2 << 30),
])
def test_hbm_budget(stats, want):
    assert dsops.hbm_budget(_FakeDevice(stats)) == want


def test_hbm_budget_default_device_cpu():
    assert dsops.hbm_budget() == 2 << 30     # the CPU reports no limit


@pytest.mark.parametrize("budget,want", [(None, "fold"), (0, None)])
def test_os_route_follows_budget(monkeypatch, budget, want):
    rng = np.random.default_rng(3)
    bank = dsops.build_bank(_bases(rng, 2, 2, 90), 3, 9000, prefer_os=True)
    if budget is not None:
        monkeypatch.setattr(dsops, "hbm_budget", lambda device=None: budget)
    st = pscan._bank_statics(bank, 3)
    route, arrs, th = pscan._os_fold_route(bank, st, 4, 9000,
                                           np.ones(2, np.float32))
    assert route == want and len(arrs) == 3 and th.shape == (2,)


def test_fold_scan_fits_counts_the_intermediate(monkeypatch):
    # [B, S, Dmax, m, blk] float32 against the budget, exactly at the edge
    _, _, _, W, m = dsops._os_geometry(3000, 30, 512)
    need = 2 * 8 * 4 * m * 512 * 4
    monkeypatch.setattr(dsops, "hbm_budget", lambda device=None: need)
    assert dsops.fold_scan_fits(2, 8, 4, 30, 512, 3000)
    assert not dsops.fold_scan_fits(3, 8, 4, 30, 512, 3000)
