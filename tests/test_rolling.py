"""Rolling-statistics kernels vs pandas oracles."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from detex_tpu.ops import rolling


@pytest.mark.parametrize("n", [3, 50, 128])
def test_rolling_mean_matches_pandas(rng, n):
    x = rng.standard_normal(1000)
    got = np.asarray(rolling.rolling_mean(jnp.asarray(x), n))
    want = pd.Series(x).rolling(n).mean().values[n - 1:]
    assert np.allclose(got, want, atol=1e-6)


def test_rolling_var_matches_population(rng):
    x = rng.standard_normal(2000) * 3 + 5
    n = 77
    _, var = rolling.rolling_mean_var(jnp.asarray(x), n)
    want = pd.Series(x).rolling(n).var().values[n - 1:] * (n - 1) / n
    assert np.allclose(np.asarray(var), want, rtol=1e-4, atol=1e-6)


def test_rolling_std_population_correction(rng):
    # the reference multiplies pandas sample std by sqrt((n-1)/n)
    x = rng.standard_normal(500)
    n = 30
    got = np.asarray(rolling.rolling_std(jnp.asarray(x), n))
    want = (pd.Series(x).rolling(n).std().values[n - 1:]
            * np.sqrt((n - 1.0) / n))
    assert np.allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [3, 4, 5, 10])
def test_rolling_mean_centered_matches_pandas(rng, n):
    x = rng.standard_normal(101)
    got = np.asarray(rolling.rolling_mean_centered(jnp.asarray(x), n))
    want = pd.Series(x).rolling(n, center=True).mean().values
    mask = ~np.isnan(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    assert np.allclose(got[mask], want[mask], atol=1e-6)


def test_rolling_precision_long_chunk(rng):
    # f32 cumsum over a million samples must stay accurate (centered trick)
    x = (rng.standard_normal(1_000_000) + 100.0).astype(np.float32)
    n = 4500
    got = np.asarray(rolling.rolling_mean(jnp.asarray(x), n))
    want = pd.Series(x.astype(np.float64)).rolling(n).mean().values[n - 1:]
    assert np.abs(got - want).max() < 1e-3  # absolute on values ~100


@pytest.mark.parametrize("n,L", [(3, 257), (300, 7777), (128, 16384)])
def test_rolling_sum_rows_matches_oracle(rng, n, L):
    # the batched prefix-sum form must match both the 1-D kernel and the
    # exact f64 window-sum oracle
    x = rng.standard_normal((4, L)).astype(np.float32)
    got = np.asarray(rolling.rolling_sum_rows(jnp.asarray(x), n))
    one_d = np.stack([np.asarray(rolling.rolling_sum(r, n)) for r in x])
    oracle = np.stack([np.convolve(np.asarray(r, np.float64),
                                   np.ones(n), "valid") for r in x])
    assert got.shape == oracle.shape
    assert np.abs(got - oracle).max() < 5e-5
    assert np.abs(one_d - oracle).max() < 5e-5


def test_window_stats_rows_matches_reference_formula(rng):
    # (a, power) must equal the per-channel rolling-sum formulation the
    # DS kernels used before (reference detect.py:566-568 semantics)
    B, nc, L_c, n_c = 2, 3, 5000, 90
    n = n_c * nc
    xc = rng.standard_normal((B, nc, L_c)).astype(np.float32)
    a, power = rolling.window_stats_rows(jnp.asarray(xc), n_c, n)
    x64 = np.asarray(xc, np.float64)
    s1 = np.stack([sum(np.convolve(x64[b, c], np.ones(n_c), "valid")
                       for c in range(nc)) for b in range(B)])
    s2 = np.stack([sum(np.convolve(x64[b, c] ** 2, np.ones(n_c), "valid")
                       for c in range(nc)) for b in range(B)])
    a64 = s1 / n
    var = (s2 - s1 * s1 / n) / (n - 1.0)
    p64 = np.maximum(var, 0.0) * n
    assert np.abs(np.asarray(a) - a64).max() < 5e-6
    assert np.abs(np.asarray(power) - p64).max() < 5e-4
