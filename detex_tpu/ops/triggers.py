"""
Trigger extraction: iterative argmax-above-threshold with suppression.

The reference mutates the DS array in a Python while loop
(_CreateCoeffArray detect.py:390-445 + _downPlayArrayAroundMax :545-557).
Here the same ordering/suppression semantics run inside one
``lax.while_loop`` on device, emitting a fixed-size padded trigger list.
Suppression exactly mirrors the reference's three-case zeroing:

    index <  buff*sr + 1        -> zero [0, index + buff*sr)
    index >  len - buff*sr      -> zero [index - buff*sr, end)
    otherwise                   -> zero [index - buff*sr, index + buff*sr)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_MAX_TRIGGERS = 512


def extract_triggers_np(ceval, threshold, buff_samps,
                        max_triggers=DEFAULT_MAX_TRIGGERS):
    """
    Host float64 twin of extract_triggers, used by the dtype='double'
    exact path: identical argmax/suppression semantics without the device
    f32 cast. Returns int64 indices in emission order.
    """
    c = np.array(ceval, dtype=np.float64, copy=True)
    L = len(c)
    out = []
    while len(out) < max_triggers and L and np.max(c) >= threshold:
        i = int(np.argmax(c))
        out.append(i)
        if i < buff_samps + 1:
            lo, hi = 0, i + buff_samps
        elif i > L - buff_samps:
            lo, hi = i - buff_samps, L
        else:
            lo, hi = i - buff_samps, i + buff_samps
        c[lo:hi] = 0.0
    return np.asarray(out, np.int64)


@partial(jax.jit, static_argnames=("buff_samps", "max_triggers"))
def extract_triggers(ceval, threshold, buff_samps,
                     max_triggers=DEFAULT_MAX_TRIGGERS):
    """
    Parameters
    ----------
    ceval : [L] detection statistic (or its STA/LTA) to trigger on
    threshold : scalar trigger threshold (trigger when value >= threshold)
    buff_samps : int, suppression half-width in samples (buff seconds * sr)
    max_triggers : int, trigger list capacity (reference errors out at 4000
        triggers in one block; capacity plays that role here)

    Returns
    -------
    (indices [max_triggers] int32, count int32): indices of triggers in the
    order the reference would emit them (descending DS with suppression);
    entries >= count are -1.
    """
    L = ceval.shape[0]
    idx_range = jnp.arange(L)

    def cond(state):
        c, out, k = state
        return (jnp.max(c) >= threshold) & (k < max_triggers)

    def body(state):
        c, out, k = state
        i = jnp.argmax(c)
        out = out.at[k].set(i.astype(jnp.int32))
        lo = jnp.where(i < buff_samps + 1, 0, i - buff_samps)
        hi = jnp.where(i < buff_samps + 1, i + buff_samps,
                       jnp.where(i > L - buff_samps, L, i + buff_samps))
        c = jnp.where((idx_range >= lo) & (idx_range < hi), 0.0, c)
        return c, out, k + 1

    # derive initial carries from the input so they inherit any varying
    # manual axes when this runs inside shard_map
    zero = (ceval[0] * 0).astype(jnp.int32)
    out0 = jnp.full((max_triggers,), -1, dtype=jnp.int32) + zero
    _, out, count = jax.lax.while_loop(cond, body,
                                       (ceval.astype(jnp.float32), out0,
                                        zero))
    return out, count


@partial(jax.jit, static_argnames=("buff_samps", "max_triggers"))
def extract_triggers_topk(ceval, threshold, buff_samps, max_triggers=64):
    """
    Fixed-iteration variant of extract_triggers: a ``lax.scan`` of exactly
    ``max_triggers`` argmax+suppress steps (masked once the threshold is no
    longer met). Identical outputs for up to ``max_triggers`` triggers, but
    static-shape control flow that compiles and vmaps far better — used on
    the batched/sharded scan path.
    """
    L = ceval.shape[0]
    idx_range = jnp.arange(L)

    def body(c, _):
        i = jnp.argmax(c)
        valid = c[i] >= threshold
        lo = jnp.where(i < buff_samps + 1, 0, i - buff_samps)
        hi = jnp.where(i < buff_samps + 1, i + buff_samps,
                       jnp.where(i > L - buff_samps, L, i + buff_samps))
        suppress = valid & (idx_range >= lo) & (idx_range < hi)
        c = jnp.where(suppress, 0.0, c)
        return c, jnp.where(valid, i.astype(jnp.int32), jnp.int32(-1))

    _, out = jax.lax.scan(body, ceval.astype(jnp.float32), None,
                          length=max_triggers)
    count = jnp.sum((out >= 0).astype(jnp.int32))
    return out, count


def _pyramid_suppress_scan(cp, pyr0, threshold, buff_samps, max_triggers,
                           block, L):
    """Shared argmax/suppression scan over a block-max pyramid.

    ``cp`` [nblk*block] is the (padded) statistic, ``pyr0`` [nblk] its
    per-block maxima, ``L`` the reference length for the three-case
    suppression clamp. Each step takes the pyramid argmax, recovers the
    exact first-occurrence index by re-reading just that block with the
    accumulated suppression intervals masked to 0.0 (the reference
    zeroes, not removes), zeroes fully-covered blocks in the summary,
    and recomputes the two boundary blocks. Output-identical to
    extract_triggers_topk for any threshold > 0."""
    nblk = pyr0.shape[0]
    pos_in_blk = jnp.arange(block, dtype=jnp.int32)
    bidx = jnp.arange(nblk, dtype=jnp.int32)

    def recompute(b, los, his):
        vals = jax.lax.dynamic_slice(cp, (b * block,), (block,))
        pos = b * block + pos_in_blk
        inside = ((pos[None, :] >= los[:, None]) &
                  (pos[None, :] < his[:, None])).any(axis=0)
        vals = jnp.where(inside, 0.0, vals)
        return vals.max(), b * block + vals.argmax().astype(jnp.int32)

    def body(carry, _):
        pyr, los, his, k = carry
        j = jnp.argmax(pyr)
        valid = pyr[j] >= threshold
        # exact first-occurrence index inside the winning block
        _, i = recompute(j, los, his)
        lo = jnp.where(i < buff_samps + 1, 0, i - buff_samps)
        hi = jnp.where(i < buff_samps + 1, i + buff_samps,
                       jnp.where(i > L - buff_samps, L, i + buff_samps))
        los = los.at[k].set(jnp.where(valid, lo, L + 1))
        his = his.at[k].set(jnp.where(valid, hi, 0))
        # blocks fully inside [lo, hi): summary -> zeroed block
        full = valid & (bidx * block >= lo) & ((bidx + 1) * block <= hi)
        pyr = jnp.where(full, 0.0, pyr)
        # the (at most two) partially covered boundary blocks
        blo = jnp.clip(lo // block, 0, nblk - 1).astype(jnp.int32)
        bhi = jnp.clip((hi - 1) // block, 0, nblk - 1).astype(jnp.int32)
        for b in (blo, bhi):
            bm, _ = recompute(b, los, his)
            pyr = pyr.at[b].set(jnp.where(valid, bm, pyr[b]))
        out_i = jnp.where(valid, i.astype(jnp.int32), jnp.int32(-1))
        return (pyr, los, his, k + 1), out_i

    # derive every initial carry from the input so they inherit varying
    # manual axes inside shard_map (same trick as extract_triggers)
    zero = (cp[0] * 0).astype(jnp.int32)
    los0 = jnp.full((max_triggers,), L + 1, jnp.int32) + zero
    his0 = jnp.zeros((max_triggers,), jnp.int32) + zero
    _, out = jax.lax.scan(body, (pyr0.astype(jnp.float32), los0, his0,
                                 zero), None, length=max_triggers)
    count = jnp.sum((out >= 0).astype(jnp.int32))
    return out, count


@partial(jax.jit, static_argnames=("L", "sta_n", "lta_n", "buff_samps",
                                   "max_triggers", "use_stalta"))
def trigger_rows_device(rows, thr, L, sta_n, lta_n, buff_samps,
                        max_triggers, use_stalta):
    """Device-windowed dense re-verify: replicate the engine's per-row
    host chain (detect._materializeOne) entirely on device so only the
    per-trigger indices/values cross the device->host link instead of
    three full DS-row round trips per triggered detector.

    The chain per row, in the exact host order (reference
    detect.py:270-281 inf-zeroing + :390-445 extraction + :501-524
    STA/LTA):

      1. truncate to the chunk's ``L`` valid windows
      2. if max(row) > 1.1, zero non-finite values (NaN max keeps the
         row untouched, matching numpy's NaN-propagating max)
      3. optional centered STA/LTA (stalta._stalta_kernel, the same
         kernel the host path uploads the row back to device for)
      4. extract_triggers (the while_loop op, vmapped — jax batches a
         while_loop by masking finished lanes, so per-lane results are
         bit-identical to the scalar call on the same row)
      5. gather DS / STA-LTA values at the trigger indices

    Parameters: rows [R, >=L] f32 DS rows, thr [R] per-row thresholds,
    ``sta_n``/``lta_n`` pre-clamped integer window lengths (the caller
    replicates ds_stalta's max(int(.),0|1) clamps). Returns
    (idx [R, K] int32 -1-padded, count [R] int32, ds_at [R, K],
    stalta_at [R, K] — zeros when ``use_stalta`` is False).
    """
    r = rows[:, :L].astype(jnp.float32)
    mx = jnp.max(r, axis=1, keepdims=True)
    r = jnp.where(mx > 1.1, jnp.where(jnp.isfinite(r), r, 0.0), r)
    if use_stalta:
        from detex_tpu.ops.stalta import _stalta_kernel
        sl = jax.vmap(lambda x: _stalta_kernel(x, sta_n, lta_n))(r)
    idx, cnt = jax.vmap(
        lambda c, t: extract_triggers(c, t, buff_samps, max_triggers)
    )(r, thr)
    safe = jnp.maximum(idx, 0)
    dsv = jnp.take_along_axis(r, safe, axis=1)
    slv = (jnp.take_along_axis(sl, safe, axis=1) if use_stalta
           else jnp.zeros_like(dsv))
    return idx, cnt, dsv, slv


@partial(jax.jit, static_argnames=("buff_samps", "max_triggers", "block"))
def extract_triggers_pyramid(ceval, threshold, buff_samps, max_triggers=64,
                             block=512):
    """
    Block-max pyramid variant of ``extract_triggers_topk`` with identical
    outputs (same argmax-first-occurrence and three-case suppression
    semantics, reference detect.py:390-445, 545-557).

    ``extract_triggers_topk`` carries the full [L] statistic through a
    ``max_triggers``-step scan — at a 1000-detector bank that carry is
    GB-scale HBM traffic per chunk. Here the scan carries only per-block
    maxima; the selected block is re-read to recover the exact index.
    """
    L = ceval.shape[0]
    c = ceval.astype(jnp.float32)
    nblk = -(-L // block)
    cp = jnp.pad(c, (0, nblk * block - L), constant_values=-jnp.inf)
    pyr0 = cp.reshape(nblk, block).max(axis=1)
    return _pyramid_suppress_scan(cp, pyr0, threshold, buff_samps,
                                  max_triggers, block, L)


@partial(jax.jit, static_argnames=("buff_samps", "max_triggers", "block"))
def extract_triggers_pyramid_pm(ceval, pyr_max, threshold, buff_samps,
                                max_triggers=64, block=128):
    """
    extract_triggers_pyramid with a PRECOMPUTED block-max pyramid (e.g.
    emitted alongside the masked DS by ops/ds._mask_pyramid).
    ``ceval`` must have length ``len(pyr_max) * block`` (pad positions
    pre-masked to -inf). Output-identical to extract_triggers_topk on
    the same ceval.
    """
    L = ceval.shape[0]
    assert pyr_max.shape[0] * block == L
    return _pyramid_suppress_scan(ceval.astype(jnp.float32), pyr_max,
                                  threshold, buff_samps, max_triggers,
                                  block, L)


@partial(jax.jit, static_argnames=("cap",))
def pack_trigger_outputs(idx, cnt, dsv, slv, cap):
    """Pack trigger_rows_device outputs into ONE transferable f32 array
    [R, 1 + cap * (2 | 3)]: column 0 the per-row counts, then the first
    ``cap`` columns of idx, ds values, and (when ``slv`` is not None) the
    STA/LTA values. idx and cnt are small integers (< 2^24 — the caller
    guards the row length), exact in float32; ds/stalta are f32 already,
    so the round trip is bit-exact. One packed transfer replaces the
    count round trip + one per output array on the dense re-verify path."""
    parts = [cnt[:, None].astype(jnp.float32),
             idx[:, :cap].astype(jnp.float32),
             dsv[:, :cap].astype(jnp.float32)]
    if slv is not None:
        parts.append(slv[:, :cap].astype(jnp.float32))
    return jnp.concatenate(parts, axis=1)
