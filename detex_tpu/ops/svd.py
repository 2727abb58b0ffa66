"""
SVD and fractional-energy-capture helpers (reference subspace.py:786-1013).

dtype='single' runs the SVD on device in float32 (projections at
HIGHEST matmul precision, so a GPU keeps full float32 instead of TF32);
dtype='double' runs it on host in float64, matching the reference's
scipy.linalg.svd numerics (subspace.py:890) exactly — basis vectors,
thresholds and downstream DS values then agree with a float64 oracle to
~1e-12 instead of f32's ~1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def svd_basis(aligned, normalize=False, dtype="double"):
    """
    SVD of aligned, demeaned event waveforms.

    Parameters
    ----------
    aligned : [N_events, n] array (each row one aligned waveform; rows are
        demeaned by the caller, reference _trimGroups subspace.py:921-943).
    normalize : bool — normalize each row to unit energy first
        (reference SVD() normalize flag).
    dtype : 'double' (host float64, reference numerics) or 'single'
        (device float32).

    Returns
    -------
    (U [n, k], s [k]) with k = min(N, n): left singular vectors (columns)
    and singular values, descending. Matches scipy.linalg.svd(tparr,
    full_matrices=False) at subspace.py:890.
    """
    if dtype == "double":
        arr = np.asarray(aligned, np.float64)
        if normalize:
            arr = arr / np.linalg.norm(arr, axis=1, keepdims=True)
        U, s, _ = np.linalg.svd(arr.T, full_matrices=False)
        return U, s
    arr = jnp.asarray(aligned, jnp.float32)
    if normalize:
        arr = arr / jnp.linalg.norm(arr, axis=1, keepdims=True)
    U, s, _ = jnp.linalg.svd(arr.T, full_matrices=False)
    return np.asarray(U, np.float64), np.asarray(s, np.float64)


def frac_energy(U, aligned, dtype="double"):
    """
    Cumulative fractional energy captured per dimension of representation
    for each training waveform (reference _getFracEnergy
    subspace.py:968-997).

    Parameters
    ----------
    U : [n, k] left singular vectors
    aligned : [N, n] aligned (trimmed, NOT demeaned — the reference passes
        the raw aligned waveform here) training waveforms
    dtype : 'double' (host float64) or 'single' (device float32)

    Returns
    -------
    cum : [N, k+1] cumulative energy capture (leading 0 for dim 0)
    """
    if dtype == "double":
        U = np.asarray(U, np.float64)
        A = np.asarray(aligned, np.float64)
        proj = A @ U                                      # [N, k]
        rep = (proj / np.linalg.norm(A, axis=1, keepdims=True)) ** 2
        return np.concatenate([np.zeros((A.shape[0], 1)),
                               np.cumsum(rep, axis=1)], axis=1)
    U = jnp.asarray(U, jnp.float32)
    A = jnp.asarray(aligned, jnp.float32)
    proj = jnp.matmul(A, U, precision=jax.lax.Precision.HIGHEST)  # [N, k]
    norm = jnp.linalg.norm(A, axis=1, keepdims=True)
    rep = (proj / norm) ** 2
    cum = jnp.concatenate([jnp.zeros((A.shape[0], 1)),
                           jnp.cumsum(rep, axis=1)], axis=1)
    return np.asarray(cum, np.float64)
