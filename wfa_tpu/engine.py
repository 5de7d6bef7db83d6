"""Batched score-loop engine (JAX / XLA).

Batched re-design of the reference's per-pair scalar score loop
(wfa.go:228-251): a whole batch of pairs advances in lockstep, one score
per iteration of a single compiled loop, with per-pair done masks.
Storage is dense, not pointer-chased:

* per component (M/I/D) an ``int32[S_cap, B, K_win]`` history of packed
  cells (``offset << 3 | tag``, 0 = absent — the same encoding as the
  reference, wfa_wavefront.go:44/93, so backtraces replay bit-identically);
* a *fixed per-pair window origin* ``k0[b]`` maps window column j to
  diagonal ``k = k0 + j`` for every score.  A fixed origin makes all of
  next()'s shifted source reads static ±1 column shifts — no gathers —
  and lets the target sequence be pre-placed at column offset ``-k0`` so
  extension compares are uniform across the batch;
* per-component live bands ``lo/hi[S_cap, B]`` and existence flags (the
  dense analogs of wfa_wavefront.go:45-48 / wfa_component.go:81-101).

One engine iteration fuses the reference's extend (wfa.go:381-458) —
one masked pass over precomputed stop tables plus a count-leading-zeros,
see ``_stop_tables`` — the termination test (wfa.go:235-239), wf-adaptive
reduction (wfa.go:461-540) expressed as masked band-bound updates, and
next (wfa.go:549-700) as shifted window reads + element-wise max/select
with the reference's exact tie-breaking.

This loop is the only score-loop path on every platform.  The
sequential, data-dependent backtrace also runs on device
(wfa_tpu.device_backtrace) so only compact op-token buffers ever leave
the device; the backtrace-aux history stays in device memory.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .cigar import AlignmentResult
from .constants import (
    MAX_SEQ_LEN,
    T_DEL_EXT,
    T_DEL_OPEN,
    T_INS_EXT,
    T_INS_OPEN,
    T_MATCH,
    T_MISMATCH,
    TYPE_BITS,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from .oracle import Aligner as OracleAligner

_BIG = np.int32(1 << 30)

# Process-wide jax-dispatch lock.  The pipeline dispatches jitted
# programs and slice primitives from several worker threads; concurrent
# FIRST-COMPILES inside jaxlib (pxla.from_hlo racing other dispatch)
# segfault intermittently (observed twice in the CPU test suite).  All
# engine-side jax CALL sites (jit dispatch, output slicing) take this
# lock; blocking transfers (np.asarray fetches, jnp.asarray uploads) and
# pure-numpy work stay outside it, so the serialized window is ~ms per
# batch once warm while uploads/downloads still overlap freely.
import threading

DISPATCH_LOCK = threading.RLock()


def _host_fetch(x):
    """Device array -> numpy.  Multi-host global arrays span
    non-addressable shards that ``device_get`` refuses; gather them
    across processes first (tiled => concatenated along the sharded
    axis, i.e. the original global array)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _global_args(mesh, host_args):
    """Upload host numpy args as batch-sharded global jax.Arrays (every
    process holds the same full input, so each serves any shard)."""
    from jax.sharding import NamedSharding, PartitionSpec

    sh = NamedSharding(mesh, PartitionSpec("dp"))
    return tuple(
        jax.make_array_from_callback(a.shape, sh, lambda idx, a=a: a[idx])
        for a in host_args)


def _coarse(n: int, lo: int = 512) -> int:
    """Round up to a coarse grid (>= 1/8 of the magnitude) so adaptive
    fetch-slice extents reuse compiled slice programs — every distinct
    extent otherwise compiles a fresh ~0.5 s slice program per batch."""
    g = lo
    while g * 8 < n:
        g *= 2
    return ((n + g - 1) // g) * g


def _pad_len(n: int) -> int:
    """Pad buffer lengths to coarse steps so same-bucket chunks with
    slightly different maxima share one compiled program."""
    g = 128 if n <= 4096 else 2048
    return ((n + g - 1) // g) * g

# columns of the fused per-pair "meta" output tensor (int32[B, 4]) —
# one tensor so the host fetches all scalars in one transfer.
# Stats and matched-region coordinates are NOT downloaded: they derive
# from the decoded ops host-side exactly as the reference's process()
# derives stats (AlignmentResult._derive_from_ops).  (n_long counts the
# byte-stream path's full-width long tokens; zero on the other output
# layouts.)
META_COLS = ("score", "overflow", "trim_len", "n_long")
M_SCORE, M_OVF, M_TRIM, M_LONG = range(4)


class _State(NamedTuple):
    s: jnp.ndarray  # scalar int32 — current score (lockstep)
    done: jnp.ndarray  # [B] bool
    overflow: jnp.ndarray  # [B] bool — window/score-cap overflow → fallback
    final_s: jnp.ndarray  # [B] int32
    hist_m: jnp.ndarray  # [S, B, K] int32 packed cells
    hist_i: jnp.ndarray
    hist_d: jnp.ndarray
    aux_m: jnp.ndarray  # [S, B, K] int32 backtrace aux: offset0 << 3 | tag
    aux_i: jnp.ndarray
    aux_d: jnp.ndarray
    lo_m: jnp.ndarray  # [S, B] int32 live band (k-space)
    hi_m: jnp.ndarray
    lo_i: jnp.ndarray
    hi_i: jnp.ndarray
    lo_d: jnp.ndarray
    hi_d: jnp.ndarray
    ex_m: jnp.ndarray  # [S, B] bool — wavefront exists (has_score)
    ex_i: jnp.ndarray
    ex_d: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    penalties: Penalties = Penalties()
    global_alignment: bool = True
    adaptive: Optional[AdaptiveReductionOption] = None
    k_win: int = 128  # diagonal window width (multiple of 128 preferred)
    s_cap: int = 256  # max score + 1
    # stop-table read window (32-bit words) per extension step; None reads
    # the whole table.  For long sequences the full table is too large to
    # stream every step — a window anchored at the batch's minimum live
    # word covers it (offsets advance monotonically and pairs in a
    # length-bucketed batch progress together); pairs that outrun the
    # window are marked overflow and retried wider.
    w_win: Optional[int] = None


def window_origin(qlen: int, tlen: int, k_win: int, global_alignment: bool) -> int:
    """Fixed per-pair window origin k0 (column 0's diagonal).

    Global: centered between the seed diagonal 0 and the terminal diagonal
    Ak = tlen-qlen.  Semi-global: the full range starts at -(qlen-1)."""
    if not global_alignment:
        return -(qlen - 1)
    ak = tlen - qlen
    return ak // 2 - k_win // 2


# single-pass vs chunked threshold for the c-space stop-table doubling
# (bytes of the whole-K intermediate); tests shrink it to force the
# chunked branch on small inputs
_STOP_TABLES_CHUNK_BYTES = 2 << 30


def _stop_tables(qb, tbuf, qlen, tlen, toff, K: int, Lq: int, Ltb: int):
    """Precompute the extension stop tables (the batched replacement of
    the reference's per-byte LCP walk, wfa.go:411-454).

    With the fixed per-pair window origin (k0 = -toff), window diagonal j
    at target position h lives at target-buffer column ``c = h + toff``
    and compares query position ``v = c - j``.  Define the *stop bit*
    stop[b, j, c] = 1 unless (v, h) are in bounds and q[v] == t[h]; then
    the reference's match-run length from offset h is exactly
    ``(first c' >= c with stop) - c``.

    Returns:
      words [B, K, Lw] int32 — stop bits packed 32/word, bit (31-(c&31))
        of word c>>5 (big-endian within the word, like the reference's
        big-endian uint64 packing, wfa.go:415);
      fsa   [B, K, Lw] int32 — absolute column of the first stop bit in
        any word *after* word w (suffix scan), always finite because
        every column >= toff+tlen is a stop.

    One masked pass over these per score step replaces the reference's
    data-dependent LCP loop — no gathers, no inner while_loop.
    """
    B = qb.shape[0]
    Lwc = (Ltb + 32) // 32  # ≥1 stop column beyond every toff+tlen
    Lc = Lwc * 32

    # q_sh[b, j, c] = q[b, c - j] — K shifted copies of q built by
    # concat-and-shift doublings.  The whole-K doubling materializes a
    # [B, pow2(K), K + Lc] byte tensor — 19.8 GB at B=8, K=20k on the
    # semi-global full-span tier — so BIG builds run CK diagonals at a
    # time; small ones keep the single-pass build, which avoids the
    # chunk loop's fori/dynamic-update overhead.
    pow2k = 1 << max(0, K - 1).bit_length()
    if B * pow2k * (K + Lc) <= _STOP_TABLES_CHUNK_BYTES:
        Lp = K + Lc
        qpad = jnp.zeros((B, 1, Lp), jnp.uint8)
        qpad = lax.dynamic_update_slice(qpad, qb[:, None, :], (0, 0, K))
        R = qpad
        d = 1
        while d < K:
            shifted = jnp.pad(R, ((0, 0), (0, 0), (d, 0)))[:, :, :Lp]
            R = jnp.concatenate([R, shifted], axis=1)
            d *= 2
        q_sh = lax.slice(R, (0, 0, K), (B, K, K + Lc))  # [B, K, Lc]
        tpad = jnp.zeros((B, Lc), jnp.uint8)
        tpad = lax.dynamic_update_slice(tpad, tbuf, (0, 0))
        cs = jnp.arange(Lc, dtype=jnp.int32)[None, None, :]
        js = jnp.arange(K, dtype=jnp.int32)[None, :, None]
        vs = cs - js
        valid = (
            (vs >= 0)
            & (vs < qlen[:, None, None])
            & (cs >= toff[:, None, None])
            & (cs < (toff + tlen)[:, None, None])
        )
        stop = ~(valid & (q_sh == tpad[:, None, :]))  # [B, K, Lc]
        bits = stop.reshape(B, K, Lwc, 32).astype(jnp.int32)
        weights = (jnp.int32(1) << (31 - jnp.arange(32, dtype=jnp.int32)))
        words = jnp.sum(bits * weights[None, None, None, :], axis=-1)
        wclz = lax.clz(words)
        wpos = jnp.where(
            words != 0,
            jnp.arange(Lwc, dtype=jnp.int32)[None, None, :] * 32 + wclz,
            _BIG,
        )
        suff = lax.cummin(wpos, axis=2, reverse=True)
        fsa = jnp.concatenate(
            [suff[..., 1:], jnp.full_like(suff[..., :1], _BIG)], axis=-1)
        return words, fsa
    CK = 256 if K % 256 == 0 else 128
    CK = min(CK, K)
    Kp = ((K + CK - 1) // CK) * CK
    Lp = CK + Lc
    # qpad[b, Kp + v] = q[b, v]; chunk row r of chunk j0 reads window
    # qpad[b, Kp - j0 - r : ... + Lc]
    qpad = jnp.zeros((B, Kp + Lc), jnp.uint8)
    qpad = lax.dynamic_update_slice(qpad, qb[:, :min(Lq, Lc)], (0, Kp))

    tpad = jnp.zeros((B, Lc), jnp.uint8)
    tpad = lax.dynamic_update_slice(tpad, tbuf, (0, 0))

    weights = (jnp.int32(1) << (31 - jnp.arange(32, dtype=jnp.int32)))
    cs1 = jnp.arange(Lc, dtype=jnp.int32)[None, None, :]
    rs1 = jnp.arange(CK, dtype=jnp.int32)[None, :, None]

    def _chunk(i, acc):
        j0 = i * CK
        # X[b, r', c] = qpad[b, Kp - j0 - (CK-1) + r' + c]; the chunk's
        # rows are then r = CK-1-r' (reverse along the chunk axis)
        base = Kp - j0 - (CK - 1)
        X = lax.dynamic_slice(qpad, (0, base), (B, CK - 1 + Lc))[:, None, :]
        d = 1
        while d < CK:
            shifted = jnp.pad(X, ((0, 0), (0, 0), (0, d)))[:, :, d:]
            X = jnp.concatenate([X, shifted], axis=1)
            d *= 2
        q_sh = jnp.flip(lax.slice(X, (0, 0, 0), (B, CK, Lc)), axis=1)
        js = rs1 + j0
        vs = cs1 - js
        valid = (
            (vs >= 0)
            & (vs < qlen[:, None, None])
            & (cs1 >= toff[:, None, None])
            & (cs1 < (toff + tlen)[:, None, None])
        )
        stop = ~(valid & (q_sh == tpad[:, None, :]))  # [B, CK, Lc]
        bits = stop.reshape(B, CK, Lwc, 32).astype(jnp.int32)
        wc = jnp.sum(bits * weights[None, None, None, :], axis=-1)
        return lax.dynamic_update_slice(acc, wc, (0, j0, 0))

    words = lax.fori_loop(0, Kp // CK, _chunk,
                          jnp.zeros((B, Kp, Lwc), jnp.int32))
    if Kp != K:
        words = lax.slice(words, (0, 0, 0), (B, K, Lwc))

    # first stop position within each word (32*w + clz), BIG if none
    wclz = lax.clz(words)
    wpos = jnp.where(
        words != 0,
        jnp.arange(Lwc, dtype=jnp.int32)[None, None, :] * 32 + wclz,
        _BIG,
    )
    # fsa[w] = min over w' > w of wpos[w']  (reverse suffix min, exclusive)
    suff = lax.cummin(wpos, axis=2, reverse=True)
    fsa = jnp.concatenate([suff[..., 1:], jnp.full_like(suff[..., :1], _BIG)],
                          axis=-1)
    return words, fsa


def _row_at(arr: jnp.ndarray, s) -> jnp.ndarray:
    """arr[s] with traced s: [S, B, K] -> [B, K]."""
    S, B, K = arr.shape
    return lax.dynamic_slice(arr, (s, 0, 0), (1, B, K))[0]


def _col_at(arr: jnp.ndarray, s) -> jnp.ndarray:
    """arr[s] with traced s: [S, B] -> [B]."""
    S, B = arr.shape
    return lax.dynamic_slice(arr, (s, 0), (1, B))[0]


def _set_row(arr: jnp.ndarray, s, row: jnp.ndarray) -> jnp.ndarray:
    return lax.dynamic_update_slice(arr, row[None], (s, 0, 0))


def _set_col(arr: jnp.ndarray, s, col: jnp.ndarray) -> jnp.ndarray:
    return lax.dynamic_update_slice(arr, col[None], (s, 0))


def _masked_min(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    return jnp.min(jnp.where(mask, vals, _BIG), axis=-1)


def _masked_max(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(jnp.where(mask, vals, -_BIG), axis=-1)


def _shift_km1(row: jnp.ndarray) -> jnp.ndarray:
    """value at diagonal k-1: column j-1 (zero-fill)."""
    return jnp.concatenate([jnp.zeros_like(row[:, :1]), row[:, :-1]], axis=1)


def _shift_kp1(row: jnp.ndarray) -> jnp.ndarray:
    """value at diagonal k+1: column j+1 (zero-fill)."""
    return jnp.concatenate([row[:, 1:], jnp.zeros_like(row[:, :1])], axis=1)


def _delete_range_asc(dl, dh, lo, hi):
    """Effect of the reference's ascending Delete loop over k in [dl, dh]
    on a wavefront band [lo, hi] (wfa_wavefront.go:171-183 repeated by
    wfa.go:526-535).  Returns (new_lo, new_hi, zero_lo, zero_hi); cells in
    [zero_lo, zero_hi] are zeroed (empty when zero_lo > zero_hi)."""
    nonempty = (dl <= dh) & (lo <= dh) & (hi >= dl)
    z_lo = jnp.maximum(dl, lo)
    z_hi = jnp.minimum(dh, hi)
    case_chain = lo >= dl  # Lo inside the delete range → chain advance
    hi_in = hi <= dh
    new_lo_a = jnp.where(hi_in, hi, dh + 1)
    new_hi_a = jnp.where(hi_in, hi - 1, hi)
    new_hi_b = jnp.where(hi_in, hi - 1, hi)
    new_lo = jnp.where(nonempty, jnp.where(case_chain, new_lo_a, lo), lo)
    new_hi = jnp.where(nonempty, jnp.where(case_chain, new_hi_a, new_hi_b), hi)
    z_lo = jnp.where(nonempty, z_lo, 1)
    z_hi = jnp.where(nonempty, z_hi, 0)
    return new_lo, new_hi, z_lo, z_hi


def _seed_rows(
    qb, tbuf, qlen, tlen, toff, *, mismatch: int, global_alignment: bool,
    K: int, Lq: int, Ltb: int,
):
    """Dense seed wavefront rows for scores 0 and `mismatch` (wfa.go:143-184).

    Returns ((row0, lo0, hi0, ex0), (rowx, lox, hix, exx)) with rows of
    shape [B, K] in the fixed-origin window layout.  When mismatch == 0
    everything lands in row0 and rowx is empty.
    """
    k0 = -toff.astype(jnp.int32)
    qi = qb.astype(jnp.int32)
    ti = tbuf.astype(jnp.int32)
    iota = jnp.arange(K, dtype=jnp.int32)[None, :]
    ks = k0[:, None] + iota
    t_at_col = lambda col: jnp.take_along_axis(
        ti, jnp.clip(col, 0, Ltb - 1), axis=1
    )
    if global_alignment:
        eq00 = qi[:, 0] == t_at_col(toff[:, None].astype(jnp.int32))[:, 0]
        tag0 = jnp.where(eq00, T_MATCH, T_MISMATCH).astype(jnp.int32)
        cell0 = (jnp.int32(1) << TYPE_BITS) | tag0
        at_j0 = ks == 0  # [B, K] one-hot of diagonal 0
        seed_eq = jnp.where(at_j0 & eq00[:, None], cell0[:, None], 0)
        seed_ne = jnp.where(at_j0 & (~eq00)[:, None], cell0[:, None], 0)
    else:
        # semi-global first-row/column seeds over [-(n-1), m-1]
        # (wfa.go:163-183).  k0 == -(n-1), so column j holds diagonal
        # k = j - (n-1); requires K >= n + m - 1 (overflow-checked).
        in_range = (ks >= k0[:, None]) & (ks <= (tlen - 1)[:, None])
        # k >= 0: first row, offset k+1, compare q[0] vs t[k]
        # k < 0: first column, offset 1, compare q[-k] vs t[0]
        # Gather-free: t[k] lives at buffer column ks + toff == j, a
        # plain slice/pad of tbuf; q[-k] = q[toff - j] is the reversed
        # query left-shifted per row by Lq-1-toff, decomposed into log2
        # static shifts.
        t_at_k = (ti[:, :K] if Ltb >= K
                  else jnp.pad(ti, ((0, 0), (0, K - Ltb))))
        qr = jnp.flip(qi, axis=1)  # qr[:, i] = q[:, Lq-1-i]
        if Lq < K:
            qr = jnp.pad(qr, ((0, 0), (0, K - Lq)))
        else:
            qr = qr[:, :K]
        d = jnp.maximum(Lq - 1 - toff.astype(jnp.int32), 0)
        for bit in range(max(1, K - 1).bit_length()):
            amt = 1 << bit
            if amt >= K:
                break
            sh = jnp.concatenate(
                [qr[:, amt:], jnp.zeros((qr.shape[0], amt), qr.dtype)], 1)
            qr = jnp.where((((d >> bit) & 1) == 1)[:, None], sh, qr)
        q_at_mk = qr  # [B, K]: column j holds q[toff - j] (j <= toff)
        t0 = t_at_col(toff[:, None].astype(jnp.int32))
        eq = jnp.where(ks >= 0, qi[:, :1] == t_at_k, q_at_mk == t0)
        off = jnp.where(ks >= 0, ks + 1, 1)
        seed_eq = jnp.where(in_range & eq, (off << TYPE_BITS) | T_MATCH, 0)
        seed_ne = jnp.where(in_range & ~eq, (off << TYPE_BITS) | T_MISMATCH, 0)

    if mismatch == 0:  # both seed sets land on score 0
        rows = (seed_eq + seed_ne, jnp.zeros_like(seed_eq))
    else:
        rows = (seed_eq, seed_ne)
    out = []
    for row in rows:
        any_set = jnp.any(row > 0, axis=1)
        lo_s = jnp.where(any_set, _masked_min(ks, row > 0), _BIG)
        hi_s = jnp.where(any_set, _masked_max(ks, row > 0), -_BIG)
        out.append((row, lo_s, hi_s, any_set))
    return out[0], out[1]


def _run_batch_impl(
    qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, B: int, Lq: int, Ltb: int
):
    """Run the full score loop for a padded batch; returns final state.

    ``tbuf`` holds each target pre-placed at column offset ``toff[b] ==
    -k0[b]`` so that target position h lives at column ``h + toff`` —
    uniform, gather-free extension indexing.

    Pure traced function (no jit) so it can be wrapped by ``jax.jit``
    directly or placed inside ``shard_map`` for data-parallel execution.
    """
    p = cfg.penalties
    x = np.int32(p.mismatch)
    oe = np.int32(p.gap_open + p.gap_ext)
    e = np.int32(p.gap_ext)
    S = cfg.s_cap
    K = cfg.k_win
    reduce_on = cfg.adaptive is not None
    min_wf_len = np.int32(cfg.adaptive.min_wf_len if reduce_on else 0)
    max_dist_diff = np.int32(cfg.adaptive.max_dist_diff if reduce_on else 0)
    w_win = cfg.w_win

    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    toff = toff.astype(jnp.int32)
    k0 = -toff  # [B] fixed window origin
    stop_words, stop_fsa = _stop_tables(
        qb, tbuf, qlen, tlen, toff, K, Lq, Ltb)
    Lw = stop_words.shape[-1]
    iw = jnp.arange(Lw, dtype=jnp.int32)[None, None, :]
    qi = qb.astype(jnp.int32)

    iota = jnp.arange(K, dtype=jnp.int32)[None, :]  # [1, K]
    ks = k0[:, None] + iota  # [B, K] — constant for the whole run
    Ak = tlen - qlen  # [B]
    j_ak = (Ak - k0)[:, None]  # [B,1] terminal diagonal's column

    # ---------------- seeding (wfa.go:143-184) ----------------
    hist_m = jnp.zeros((S, B, K), jnp.int32)
    hist_i = jnp.zeros((S, B, K), jnp.int32)
    hist_d = jnp.zeros((S, B, K), jnp.int32)
    aux_m = jnp.zeros((S, B, K), jnp.int32)
    aux_i = jnp.zeros((S, B, K), jnp.int32)
    aux_d = jnp.zeros((S, B, K), jnp.int32)
    lo_m = jnp.full((S, B), _BIG, jnp.int32)
    hi_m = jnp.full((S, B), -_BIG, jnp.int32)
    lo_i = jnp.full((S, B), _BIG, jnp.int32)
    hi_i = jnp.full((S, B), -_BIG, jnp.int32)
    lo_d = jnp.full((S, B), _BIG, jnp.int32)
    hi_d = jnp.full((S, B), -_BIG, jnp.int32)
    ex_m = jnp.zeros((S, B), bool)
    ex_i = jnp.zeros((S, B), bool)
    ex_d = jnp.zeros((S, B), bool)

    # the window must contain the seed diagonal(s) and the terminal one
    overflow0 = (
        (Ak < k0) | (Ak >= k0 + K) | (0 < k0) | (0 >= k0 + K)
    )
    if not cfg.global_alignment:
        overflow0 = overflow0 | ((tlen - 1) >= k0 + K)

    (row0, lo0, hi0, ex0), (rowx, lox, hix, exx) = _seed_rows(
        qb, tbuf, qlen, tlen, toff,
        mismatch=int(p.mismatch), global_alignment=cfg.global_alignment,
        K=K, Lq=Lq, Ltb=Ltb,
    )
    hist_m = hist_m.at[0].set(row0)
    # seed cells have no sources (the backtrace's from-itself break), so
    # their aux value is just the tag bits
    aux_m = aux_m.at[0].set(row0 & 7)
    lo_m = lo_m.at[0].set(lo0)
    hi_m = hi_m.at[0].set(hi0)
    ex_m = ex_m.at[0].set(ex0)
    if 0 < p.mismatch < S:
        hist_m = hist_m.at[int(p.mismatch)].set(rowx)
        aux_m = aux_m.at[int(p.mismatch)].set(rowx & 7)
        lo_m = lo_m.at[int(p.mismatch)].set(lox)
        hi_m = hi_m.at[int(p.mismatch)].set(hix)
        ex_m = ex_m.at[int(p.mismatch)].set(exx)
    elif p.mismatch >= S:  # mismatch seed can never fit the score cap
        overflow0 = overflow0 | exx

    state = _State(
        s=jnp.int32(0),
        done=jnp.zeros((B,), bool),
        overflow=overflow0,
        final_s=jnp.zeros((B,), jnp.int32),
        hist_m=hist_m, hist_i=hist_i, hist_d=hist_d,
        aux_m=aux_m, aux_i=aux_i, aux_d=aux_d,
        lo_m=lo_m, hi_m=hi_m, lo_i=lo_i, hi_i=hi_i, lo_d=lo_d, hi_d=hi_d,
        ex_m=ex_m, ex_i=ex_i, ex_d=ex_d,
    )

    def krange(lo_c, hi_c, ex_c, s_cur, diff):
        """KRange with the reference's (0,0) fallback (wfa_component.go:91)."""
        sp = s_cur - diff
        okd = diff <= s_cur
        spc = jnp.clip(sp, 0, S - 1)
        ex_sp = _col_at(ex_c, spc) & okd
        lo = jnp.where(ex_sp, _col_at(lo_c, spc), 0)
        hi = jnp.where(ex_sp, _col_at(hi_c, spc), 0)
        return lo, hi

    def read_row(hist, lo_c, hi_c, ex_c, s_cur, diff):
        """Source row at score s_cur - diff with per-cell found mask —
        GetAfterDiff semantics (wfa_component.go:158-167), same window."""
        sp = s_cur - diff
        okd = diff <= s_cur
        spc = jnp.clip(sp, 0, S - 1)
        row = _row_at(hist, spc)
        lo_sp = _col_at(lo_c, spc)[:, None]
        hi_sp = _col_at(hi_c, spc)[:, None]
        ex_sp = (_col_at(ex_c, spc) & okd)[:, None]
        found = ex_sp & (ks >= lo_sp) & (ks <= hi_sp) & (row > 0)
        return jnp.where(found, row >> TYPE_BITS, 0), found

    def body(st: _State) -> _State:
        s = st.s
        lo_ms = _col_at(st.lo_m, s)
        hi_ms = _col_at(st.hi_m, s)
        ex_ms = _col_at(st.ex_m, s)

        # ---------------- extend (wfa.go:381-458) ----------------
        row_m = _row_at(st.hist_m, s)
        cell = row_m
        off = cell >> TYPE_BITS
        valid = (
            (cell > 0)
            & (ks >= lo_ms[:, None])
            & (ks <= hi_ms[:, None])
            & ex_ms[:, None]
            & (~st.done)[:, None]
        )
        h0 = off
        v0 = off - ks
        act0 = (
            valid
            & (v0 > 0)
            & (v0 < qlen[:, None])
            & (h0 < tlen[:, None])
        )

        # LCP via the precomputed stop tables: one masked pass over the
        # word axis — no gathers, no data-dependent loop (wfa.go:411-454).
        c0 = h0 + toff[:, None]  # [B, K] lookup position
        w0f = jnp.clip(c0 >> 5, 0, Lw - 1)
        w0 = w0f[..., None]
        overflow = st.overflow
        outrun_now = jnp.zeros_like(st.done)
        if w_win is None or w_win >= Lw:
            sel0 = iw == w0
            word0 = jnp.sum(jnp.where(sel0, stop_words, 0), axis=-1)
            fsa0 = jnp.min(jnp.where(sel0, stop_fsa, _BIG), axis=-1)
        else:
            # windowed table read anchored at the batch's minimum live word
            wlo = jnp.min(jnp.where(act0, w0f, Lw))
            wlo = jnp.clip(wlo, 0, Lw - w_win)
            words_w = lax.dynamic_slice(
                stop_words, (0, 0, wlo), (B, K, w_win))
            fsa_w = lax.dynamic_slice(stop_fsa, (0, 0, wlo), (B, K, w_win))
            iw_w = wlo + jnp.arange(w_win, dtype=jnp.int32)[None, None, :]
            sel0 = iw_w == w0
            word0 = jnp.sum(jnp.where(sel0, words_w, 0), axis=-1)
            fsa0 = jnp.min(jnp.where(sel0, fsa_w, _BIG), axis=-1)
            outrun = act0 & (w0f >= wlo + w_win)
            outrun_now = jnp.any(outrun, axis=1)
            overflow = overflow | outrun_now
            act0 = act0 & ~outrun
        vis = word0 << (c0 & 31)  # bit of c0 now at bit 31
        n_ext = jnp.where(vis != 0, lax.clz(vis), fsa0 - c0)
        n_ext = jnp.where(act0, n_ext, 0)
        row_m = jnp.where(act0 & (n_ext > 0), cell + (n_ext << TYPE_BITS), cell)
        hist_m = _set_row(st.hist_m, s, row_m)

        # ---------------- termination (wfa.go:235-239) ----------------
        cell_ak = jnp.sum(jnp.where(iota == j_ak, row_m, 0), axis=1)
        ak_flat = Ak
        found_ak = (
            ex_ms
            & (ak_flat >= lo_ms)
            & (ak_flat <= hi_ms)
            & (cell_ak > 0)
        )
        off_ak = jnp.where(found_ak, cell_ak >> TYPE_BITS, 0)
        newly = (~st.done) & ex_ms & (off_ak >= tlen)
        final_s = jnp.where(newly, s, st.final_s)
        done = st.done | newly
        # Global: a pair that terminates at s with a table-window outrun
        # picked up THIS step never needed the outran extension (its
        # terminal cell was already past tlen, so extend skips it) — the
        # reference checks termination before moving on (wfa.go:235-239),
        # so the result is valid; cancel only bits set this step.
        # Semi-global must NOT cancel an outrun: the end finder reads
        # every stored row, and the outran diagonal's cell is missing the
        # extension the reference performs, which can change the nearest
        # stop cell and with it the chosen end — those pairs must retry.
        cancel = newly & ~st.overflow
        if not cfg.global_alignment:
            cancel = cancel & ~outrun_now
        overflow = jnp.where(cancel, False, overflow)

        # ---------------- reduce (wfa.go:461-540) ----------------
        lo_m_all, hi_m_all = st.lo_m, st.hi_m
        lo_i_all, hi_i_all = st.lo_i, st.hi_i
        lo_d_all, hi_d_all = st.lo_d, st.hi_d
        hist_i, hist_d = st.hist_i, st.hist_d
        aux_m, aux_i, aux_d = st.aux_m, st.aux_i, st.aux_d
        if reduce_on:
            red = ex_ms & (~done) & ((hi_ms - lo_ms + 1) >= min_wf_len)
            offc = row_m >> TYPE_BITS
            hs = offc
            vs = offc - ks
            validc = (row_m > 0) & (ks >= lo_ms[:, None]) & (ks <= hi_ms[:, None])
            okd = validc & ~(
                (vs < 0) | (vs >= qlen[:, None]) | (hs >= tlen[:, None])
            )
            dist = jnp.maximum(tlen[:, None] - hs, qlen[:, None] - vs)
            dmin = _masked_min(dist, okd)[:, None]
            marked = okd & ((dist - dmin) > max_dist_diff)
            good = okd & ~marked
            jj = jnp.broadcast_to(iota, marked.shape)
            first_good = _masked_min(jj, good)[:, None]
            last_mark = _masked_max(jj, marked & (jj < first_good))
            any_marked = jnp.any(marked, axis=1)
            any_good = jnp.any(good, axis=1)
            last_good = _masked_max(jj, good)
            new_lo = jnp.where(last_mark > -_BIG, k0 + last_mark + 1, lo_ms)
            new_hi = jnp.where(any_marked & any_good, k0 + last_good, hi_ms)
            new_lo = jnp.where(red, new_lo, lo_ms)
            new_hi = jnp.where(red, new_hi, hi_ms)

            zero_m = (
                validc
                & ((ks < new_lo[:, None]) | (ks > new_hi[:, None]))
                & red[:, None]
            )
            row_m = jnp.where(zero_m, 0, row_m)
            hist_m = _set_row(hist_m, s, row_m)
            aux_m = _set_row(
                aux_m, s,
                jnp.where(row_m != 0, _row_at(aux_m, s), 0))
            lo_m_all = _set_col(lo_m_all, s, jnp.where(red, new_lo, lo_ms))
            hi_m_all = _set_col(hi_m_all, s, jnp.where(red, new_hi, hi_ms))

            # co-deletion from I and D (wfa.go:526-535): two ascending
            # Delete sweeps, [lo, _lo) then (_hi, hi].
            def co_delete(hist_c, aux_c, lo_c, hi_c, ex_c):
                row = _row_at(hist_c, s)
                lo_cs = _col_at(lo_c, s)
                hi_cs = _col_at(hi_c, s)
                gate = red & _col_at(ex_c, s)
                l1, h1, zl1, zh1 = _delete_range_asc(
                    lo_ms, new_lo - 1, lo_cs, hi_cs
                )
                l2, h2, zl2, zh2 = _delete_range_asc(
                    new_hi + 1, hi_ms, l1, h1
                )
                zero = gate[:, None] & (
                    ((ks >= zl1[:, None]) & (ks <= zh1[:, None]))
                    | ((ks >= zl2[:, None]) & (ks <= zh2[:, None]))
                )
                row = jnp.where(zero, 0, row)
                hist_c = _set_row(hist_c, s, row)
                aux_c = _set_row(
                    aux_c, s, jnp.where(row != 0, _row_at(aux_c, s), 0))
                lo_c = _set_col(lo_c, s, jnp.where(gate, l2, lo_cs))
                hi_c = _set_col(hi_c, s, jnp.where(gate, h2, hi_cs))
                return hist_c, aux_c, lo_c, hi_c

            hist_i, aux_i, lo_i_all, hi_i_all = co_delete(
                hist_i, aux_i, lo_i_all, hi_i_all, st.ex_i
            )
            hist_d, aux_d, lo_d_all, hi_d_all = co_delete(
                hist_d, aux_d, lo_d_all, hi_d_all, st.ex_d
            )

        # ---------------- next (wfa.go:549-700) ----------------
        s2 = s + 1
        lo_x, hi_x = krange(lo_m_all, hi_m_all, st.ex_m, s2, x)
        lo_o, hi_o = krange(lo_m_all, hi_m_all, st.ex_m, s2, oe)
        lo_ie, hi_ie = krange(lo_i_all, hi_i_all, st.ex_i, s2, e)
        lo_de, hi_de = krange(lo_d_all, hi_d_all, st.ex_d, s2, e)

        hi_n = jnp.minimum(
            tlen - 1,
            jnp.maximum(jnp.maximum(hi_x, hi_o), jnp.maximum(hi_ie, hi_de)) + 1,
        )
        lo_n = jnp.maximum(
            -(qlen - 1),
            jnp.minimum(jnp.minimum(lo_x, lo_o), jnp.minimum(lo_ie, lo_de)) - 1,
        )

        # the fixed window must hold the new band
        overflow = overflow | (
            (~done) & ((lo_n < k0) | (hi_n >= k0 + K))
        )
        live = ((~done) & (~overflow))[:, None]

        # source rows: static ±1 column shifts (no realignment gathers)
        moe, f_moe = read_row(hist_m, lo_m_all, hi_m_all, st.ex_m, s2, oe)
        mx, f_mx = read_row(hist_m, lo_m_all, hi_m_all, st.ex_m, s2, x)
        ie, f_ie = read_row(hist_i, lo_i_all, hi_i_all, st.ex_i, s2, e)
        de, f_de = read_row(hist_d, lo_d_all, hi_d_all, st.ex_d, s2, e)

        # insertion (wfa.go:578-608): sources at k-1
        v1i = _shift_km1(moe)
        fmi = _shift_km1(f_moe.astype(jnp.int32)).astype(bool)
        v2i = _shift_km1(ie)
        fii = _shift_km1(f_ie.astype(jnp.int32)).astype(bool)
        # pre-invalidation snapshot: the backtrace recomputes offsets from
        # raw stored cells WITHOUT the bound invalidation (wfa.go:757-827)
        isk_nb = jnp.where(fmi | fii, jnp.maximum(v1i, v2i) + 1, 0)
        bad = fmi & (v1i > tlen[:, None])
        fmi, v1i = fmi & ~bad, jnp.where(bad, 0, v1i)
        bad = fii & (v2i > tlen[:, None])
        fii, v2i = fii & ~bad, jnp.where(bad, 0, v2i)
        Isk = jnp.maximum(v1i, v2i) + 1
        upd_i = fmi | fii
        tag_i = jnp.where(fmi & (v1i >= v2i), T_INS_OPEN, T_INS_EXT)

        # deletion (wfa.go:612-643): sources at k+1
        v1d = _shift_kp1(moe)
        fmd = _shift_kp1(f_moe.astype(jnp.int32)).astype(bool)
        v2d = _shift_kp1(de)
        fdd = _shift_kp1(f_de.astype(jnp.int32)).astype(bool)
        dsk_nb = jnp.where(fmd | fdd, jnp.maximum(v1d, v2d), 0)
        any_id_nb = fmi | fii | fmd | fdd
        bad = fmd & ((v1d - ks) > qlen[:, None])
        fmd, v1d = fmd & ~bad, jnp.where(bad, 0, v1d)
        bad = fdd & ((v2d - ks) > qlen[:, None])
        fdd, v2d = fdd & ~bad, jnp.where(bad, 0, v2d)
        Dsk = jnp.maximum(v1d, v2d)
        upd_d = fmd | fdd
        tag_d = jnp.where(fmd & (v1d >= v2d), T_DEL_OPEN, T_DEL_EXT)

        # mismatch / M (wfa.go:648-698)
        v1x, fmx = mx, f_mx
        off_def_nb = jnp.where(
            any_id_nb | fmx,
            jnp.maximum(jnp.maximum(isk_nb, dsk_nb), v1x + 1), 0)
        bad = fmx & ((v1x > tlen[:, None]) | ((v1x - ks) > qlen[:, None]))
        fmx, v1x = fmx & ~bad, jnp.where(bad, 0, v1x)
        Msk = jnp.maximum(
            jnp.maximum(
                jnp.where(upd_i, Isk, 0), jnp.where(upd_d, Dsk, 0)
            ),
            v1x + 1,
        )
        tag_m = jnp.where(
            fmx & (Msk == v1x + 1),
            T_MISMATCH,
            jnp.where(upd_i & (Msk == Isk), tag_i, tag_d),
        )
        wr_m = upd_i | upd_d | fmx

        band = (ks >= lo_n[:, None]) & (ks <= hi_n[:, None])
        wr_i = upd_i & band & live
        wr_d = upd_d & band & live
        wr_m = wr_m & band & live

        # write I / D rows (fresh wavefronts at s2)
        row_i_new = jnp.where(wr_i, (Isk << TYPE_BITS) | tag_i, 0)
        row_d_new = jnp.where(wr_d, (Dsk << TYPE_BITS) | tag_d, 0)
        # backtrace-aux values: each cell's branch is selected by its OWN
        # tag (InsertExt -> I-rule, DeleteExt -> D-rule, else the default
        # M-rule, wfa.go:757-817)
        aux_i_new = jnp.where(
            wr_i,
            (jnp.where(tag_i == T_INS_EXT, isk_nb, off_def_nb)
             << TYPE_BITS) | tag_i, 0)
        aux_d_new = jnp.where(
            wr_d,
            (jnp.where(tag_d == T_DEL_EXT, dsk_nb, off_def_nb)
             << TYPE_BITS) | tag_d, 0)
        aux_m_val = jnp.where(
            tag_m == T_INS_EXT, isk_nb,
            jnp.where(tag_m == T_DEL_EXT, dsk_nb, off_def_nb))

        # write M row, merging any pre-existing wavefront at s2 (the seed
        # rows at scores 0 and x; same window origin, so a plain select).
        # NB reads here must go through the UPDATED tensors (aux_m, not
        # st.aux_m): reduce only touched row s, so row s2 is identical,
        # but referencing the stale buffer after the update forces XLA to
        # keep both alive — a full O(S*B*K) copy per step that made long
        # reads (l=100k) ~40x slower than the step math
        ex_m_old = _col_at(st.ex_m, s2)
        lo_m_old = _col_at(lo_m_all, s2)
        hi_m_old = _col_at(hi_m_all, s2)
        row_m_old = _row_at(hist_m, s2)
        row_m_new = jnp.where(wr_m, (Msk << TYPE_BITS) | tag_m, row_m_old)
        aux_m_old = _row_at(aux_m, s2)
        aux_m_new = jnp.where(wr_m, (aux_m_val << TYPE_BITS) | tag_m,
                              aux_m_old)

        any_i = jnp.any(wr_i, axis=1)
        any_d = jnp.any(wr_d, axis=1)
        any_m = jnp.any(wr_m, axis=1)
        lo_i_n = _masked_min(ks, wr_i)
        hi_i_n = _masked_max(ks, wr_i)
        lo_d_n = _masked_min(ks, wr_d)
        hi_d_n = _masked_max(ks, wr_d)
        lo_m_n = jnp.minimum(
            _masked_min(ks, wr_m), jnp.where(ex_m_old, lo_m_old, _BIG)
        )
        hi_m_n = jnp.maximum(
            _masked_max(ks, wr_m), jnp.where(ex_m_old, hi_m_old, -_BIG)
        )

        frz = done | overflow
        frzc = frz[:, None]
        hist_i = _set_row(
            hist_i, s2, jnp.where(frzc, _row_at(hist_i, s2), row_i_new)
        )
        hist_d = _set_row(
            hist_d, s2, jnp.where(frzc, _row_at(hist_d, s2), row_d_new)
        )
        hist_m = _set_row(
            hist_m, s2, jnp.where(frzc, row_m_old, row_m_new)
        )
        aux_i = _set_row(
            aux_i, s2, jnp.where(frzc, _row_at(aux_i, s2), aux_i_new)
        )
        aux_d = _set_row(
            aux_d, s2, jnp.where(frzc, _row_at(aux_d, s2), aux_d_new)
        )
        aux_m = _set_row(
            aux_m, s2, jnp.where(frzc, aux_m_old, aux_m_new)
        )
        lo_i_all = _set_col(
            lo_i_all, s2,
            jnp.where(frz, _col_at(lo_i_all, s2),
                      jnp.where(any_i, lo_i_n, _BIG)),
        )
        hi_i_all = _set_col(
            hi_i_all, s2,
            jnp.where(frz, _col_at(hi_i_all, s2),
                      jnp.where(any_i, hi_i_n, -_BIG)),
        )
        lo_d_all = _set_col(
            lo_d_all, s2,
            jnp.where(frz, _col_at(lo_d_all, s2),
                      jnp.where(any_d, lo_d_n, _BIG)),
        )
        hi_d_all = _set_col(
            hi_d_all, s2,
            jnp.where(frz, _col_at(hi_d_all, s2),
                      jnp.where(any_d, hi_d_n, -_BIG)),
        )
        lo_m_all = _set_col(
            lo_m_all, s2,
            jnp.where(frz, lo_m_old,
                      jnp.where(any_m | ex_m_old, lo_m_n, _BIG)),
        )
        hi_m_all = _set_col(
            hi_m_all, s2,
            jnp.where(frz, hi_m_old,
                      jnp.where(any_m | ex_m_old, hi_m_n, -_BIG)),
        )
        ex_i_all = _set_col(
            st.ex_i, s2, jnp.where(frz, _col_at(st.ex_i, s2), any_i)
        )
        ex_d_all = _set_col(
            st.ex_d, s2, jnp.where(frz, _col_at(st.ex_d, s2), any_d)
        )
        ex_m_all = _set_col(
            st.ex_m, s2, jnp.where(frz, ex_m_old, any_m | ex_m_old)
        )

        return _State(
            s=s2, done=done, overflow=overflow, final_s=final_s,
            hist_m=hist_m, hist_i=hist_i, hist_d=hist_d,
            aux_m=aux_m, aux_i=aux_i, aux_d=aux_d,
            lo_m=lo_m_all, hi_m=hi_m_all,
            lo_i=lo_i_all, hi_i=hi_i_all,
            lo_d=lo_d_all, hi_d=hi_d_all,
            ex_m=ex_m_all, ex_i=ex_i_all, ex_d=ex_d_all,
        )

    def cond(st: _State):
        return (st.s < S - 1) & jnp.any(~(st.done | st.overflow))

    final = lax.while_loop(cond, body, state)
    overflow = final.overflow | ~final.done
    return final._replace(overflow=overflow)


_run_batch = functools.partial(
    jax.jit, static_argnames=("cfg", "B", "Lq", "Ltb")
)(_run_batch_impl)


_ACGT_LUT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ACGT_LUT[_b] = _i
# pad-tolerant variant for the fast pack path: \0 -> code 0 (re-zeroed
# by the device unpack masks); in-bounds \0 is caught by the
# nonzero-count check, never by the code values
_ACGT_LUT0 = _ACGT_LUT.copy()
_ACGT_LUT0[0] = 0
_ACGT_INV = np.frombuffer(b"ACGT", np.uint8)


def _unpack2(pk, L, valid_lo, valid_hi):
    """Invert BatchAligner._pack2 on device: [B, L//4] uint8 -> [B, L]
    bytes, zeroed outside [valid_lo, valid_hi) per row."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    c = (pk[:, :, None] >> shifts[None, None, :]) & 3
    c = c.reshape(pk.shape[0], L)
    base = jnp.asarray(_ACGT_INV)[c]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    ok = (pos >= valid_lo[:, None]) & (pos < valid_hi[:, None])
    return jnp.where(ok, base, 0).astype(jnp.uint8)


def _token_plan(s_cap: int, penalties, Lq: int, Ltb: int):
    """(token_shift, compact) for the op-token outputs.

    16-bit tokens whenever run lengths fit 12 bits; device compaction
    (one key-value sort moving used tokens to the row front) whenever
    the emission stream is short enough that the sort beats fetching the
    raw trimmed rows — shared by the single-device and shard_map paths
    so their output trees can never diverge."""
    from .device_backtrace import iter_capacity

    token_shift = 12 if max(Lq, Ltb) < (1 << 12) else 28
    ns_stream = 2 * iter_capacity(s_cap, penalties) + 5
    return token_shift, ns_stream <= (1 << 16)


def _align_full_impl(
    qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, B: int, Lq: int,
    Ltb: int, packed: bool = False, flat: bool = False,
):
    """Full on-device alignment: score loop + end finder + backtrace +
    token compaction + meta packing.

    Only per-pair scalars and compact op-token buffers leave the device —
    the packed wavefront history stays in device memory.  ``flat`` emits
    the merged output as ONE 1-D tensor with the tokens cross-pair packed
    (exact-extent fetch; single-device path only — shard_map outputs keep
    the 2-D row layout so shards concatenate).
    """
    from .device_backtrace import (compact_tokens, compact_tokens_flat_u8,
                                   device_backtrace, end_finder,
                                   iter_capacity)

    S = cfg.s_cap
    K = cfg.k_win
    k0 = -toff.astype(jnp.int32)
    if packed:  # 2-bit DNA upload; reconstruct the byte buffers here
        zero = jnp.zeros_like(qlen)
        qb = _unpack2(qb, Lq, zero, qlen.astype(jnp.int32))
        tbuf = _unpack2(tbuf, Ltb, toff.astype(jnp.int32),
                        (toff + tlen).astype(jnp.int32))
    with jax.named_scope("wfa_score_loop"):
        st = _run_batch_impl(
            qb, tbuf, qlen, tlen, toff, cfg=cfg, B=B, Lq=Lq, Ltb=Ltb
        )
    aux = jnp.stack([st.aux_m, st.aux_i, st.aux_d], axis=0)
    final_s, done, overflow = st.final_s, st.done, st.overflow
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    if cfg.global_alignment:
        start_s, start_k = final_s, tlen - qlen
    else:
        with jax.named_scope("wfa_end_finder"):
            start_s, start_k, _ = end_finder(
                st.hist_m, k0, final_s, qlen, tlen, S, K,
            )
    # GetRaw of the start cell (wfa.go:738), one [B] gather
    bidx = jnp.arange(B, dtype=jnp.int32)
    j_st = start_k - k0
    ok_st = (start_s >= 0) & (start_s < S) & (j_st >= 0) & (j_st < K)
    flat_m = st.hist_m.reshape(S * B * K)
    idx = (jnp.clip(start_s, 0, S - 1) * B + bidx) * K + jnp.clip(
        j_st, 0, K - 1)
    start_cell = jnp.where(ok_st, jnp.take(flat_m, idx), 0)

    active0 = done & ~overflow
    token_shift, compact = _token_plan(S, cfg.penalties, Lq, Ltb)
    # edit-only tokens (global + flat byte-stream path): drop the match
    # runs from the download — they're recomputed host-side by LCP at
    # decode (extension is greedy-maximal).  Gap-extension steps get
    # split codes so the host knows no match run precedes them.
    edit_only = (compact and flat and cfg.global_alignment
                 and os.environ.get("WFA_EDIT_TOKENS") != "0")
    with jax.named_scope("wfa_backtrace"):
        tok0, buf, tail, it_used, qb0, qe, tb0, te = device_backtrace(
            aux, start_cell, k0, start_s, start_k, qlen, tlen, active0,
            penalties=cfg.penalties,
            global_alignment=cfg.global_alignment,
            S=S, K=K, token_shift=token_shift, split_ext_codes=edit_only,
        )
    n_long = jnp.zeros_like(start_s)
    bytes_flat = longs_flat = None
    with jax.named_scope("wfa_compact"):
        if compact and flat:
            # byte-stream tokens: each token ships as ONE byte with the
            # rare long runs spliced from a second compacted stream —
            # ~1.7x less download than int16 rows (compact_tokens_flat_u8)
            bytes_flat, longs_flat, n_tok, n_long = compact_tokens_flat_u8(
                tok0, buf, tail, token_shift, drop_m=edit_only)
            trim_len = n_tok
        elif compact:
            toks, n_tok = compact_tokens(tok0, buf, tail, token_shift)
            trim_len = n_tok
        else:
            trim_len = jnp.broadcast_to(it_used, qb0.shape)
    # ONE small per-pair tensor: the scalars ride together (META_COLS
    # names the columns; stats/coords derive from the decoded ops
    # host-side).  int16 when every column provably fits (scores <=
    # s_cap, trim <= the token-stream capacity) — halves the meta
    # download.
    meta = jnp.stack(
        [start_s, overflow.astype(jnp.int32), trim_len, n_long], axis=1)
    ns_cap = 2 * iter_capacity(S, cfg.penalties) + 5
    meta16 = max(Lq + Ltb, S, ns_cap) <= 32000
    if compact and flat:
        # the meta scalars ride IN FRONT OF the byte stream as explicit
        # little-endian bytes (2 per column when they fit int16, else
        # 4); the long-token stream is a second tensor whose async copy
        # pipelines with the first
        mb = 2 if meta16 else 4
        meta_bytes = jnp.stack(
            [(lax.shift_right_logical(meta.astype(jnp.uint32),
                                      jnp.uint32(8 * i))
              & jnp.uint32(255)).astype(jnp.uint8) for i in range(mb)],
            axis=2).reshape(-1)
        return {"mtb": jnp.concatenate([meta_bytes, bytes_flat]),
                "lg": longs_flat}
    if compact:
        # 2-D (shard_map) layout: scalars in front of the token rows,
        # one dtype.  int16 tokens imply meta fits int16 too
        # (token_shift<=12 => Lq,Ltb < 4096 => all meta bounds < 32000,
        # pipeline-capped s_cap included); direct s_cap>32000 configs
        # upcast the tokens instead.
        if toks.dtype == jnp.int16 and not meta16:
            toks = toks.astype(jnp.int32)
        return {"mt": jnp.concatenate(
            [meta.astype(toks.dtype), toks], axis=1)}
    if meta16:
        meta = meta.astype(jnp.int16)
    return {"meta": meta, "tok0": tok0, "buf": buf, "tail": tail}


def _align_full2_impl(
    seq, lens, *, cfg: EngineConfig, B: int, Lq: int, Ltb: int,
    packed: bool = False, flat: bool = False,
):
    """Combined-upload variant of :func:`_align_full_impl`.

    ``seq`` is the query|target byte matrices concatenated along axis 1
    and ``lens`` is ``stack([qlen, tlen, toff], axis=1)`` — the five
    per-batch inputs ride as two host->device transfers.  Split here
    inside the jit (free: XLA fuses the slices into the consumers).
    """
    qw = Lq // 4 if packed else Lq
    qb = lax.slice(seq, (0, 0), (B, qw))
    tbuf = lax.slice(seq, (0, qw), (B, seq.shape[1]))
    return _align_full_impl(
        qb, tbuf, lens[:, 0], lens[:, 1], lens[:, 2],
        cfg=cfg, B=B, Lq=Lq, Ltb=Ltb, packed=packed, flat=flat,
    )


_align_full2 = functools.partial(
    jax.jit,
    static_argnames=("cfg", "B", "Lq", "Ltb", "packed", "flat"),
)(_align_full2_impl)


class BatchAligner:
    """Batched aligner: device score loop + device backtrace.

    The batched replacement for the reference's one-pair-at-a-time CLI
    loop (wfa-go.go:166-178): B pairs advance in lockstep on-device; pairs
    whose bands or scores exceed the configured windows fall back to the
    exact host oracle (rare for sanely bucketed input).
    """

    def __init__(
        self,
        penalties: Penalties = Penalties(),
        options: Options = Options(),
        adaptive: Optional[AdaptiveReductionOption] = None,
        k_win: int = 128,
        s_cap: int = 256,
        w_win: Optional[int] = None,
        mesh=None,
    ) -> None:
        if adaptive is not None and adaptive.min_wf_len == 0:
            # constructor-path twin of the attach check (wfa.go:134-137)
            raise ValueError("cutoff step should not be 0")
        self.cfg = EngineConfig(
            penalties=penalties,
            global_alignment=options.global_alignment,
            adaptive=adaptive,
            k_win=k_win,
            s_cap=s_cap,
            w_win=w_win,
        )
        # data-parallel device mesh (wfa_tpu.parallel.make_dp_mesh):
        # batches shard over its 1-D dp axis; None = single device
        self.mesh = mesh if (mesh is not None
                             and mesh.devices.size > 1) else None
        self._oracle = OracleAligner(penalties, options, adaptive)
        # adaptive speculative-prefetch extents (token cols/rows), per
        # token-output kind; None until the first batch calibrates them
        self._tok_guess = {"mt": None, "toks": None, "buf": None}

    # -- public API ---------------------------------------------------------

    def pack_batch(self, pairs: Sequence[Tuple[bytes, bytes]]):
        """Pad a batch and pre-place each target at column -k0."""
        return self._pack_all(pairs)[:7]

    def _pack_all(self, pairs: Sequence[Tuple[bytes, bytes]],
                  need_raw: bool = True):
        """Build the padded row matrices AND their 2-bit uploads in one
        host pass (the native packer when built; numpy otherwise).

        Returns (qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp) with
        qp/tp None when the batch has non-ACGT bytes (raw upload path).
        This is the pipeline's host hot loop — at 2048x1kb it costs
        ~3 ms native vs ~60 ms in numpy passes.

        ``need_raw=False`` (the pipeline hot path) skips the padded raw
        rows entirely for pure-ACGT batches via the native direct
        packer (qb/tbuf come back None then — nothing reads them when
        the packed upload exists); mixed batches still fall back to the
        full build.
        """
        B = len(pairs)
        K = self.cfg.k_win
        ga = self.cfg.global_alignment
        qlen = np.fromiter((len(q) for q, _ in pairs), np.int32, B)
        tlen = np.fromiter((len(t) for _, t in pairs), np.int32, B)
        if ga:
            ak = tlen - qlen
            toff = (K // 2 - ak // 2).astype(np.int32)
        else:
            toff = qlen - 1
        Lq = _pad_len(int(qlen.max()))
        Ltb = _pad_len(max(int((toff + tlen).max()), 1))
        assert Lq % 4 == 0 and Ltb % 4 == 0

        from . import native

        if native.lib is not None and not need_raw:
            qp = native.pack_direct([q for q, _ in pairs], qlen, None, Lq)
            if qp is not None:
                tp = native.pack_direct(
                    [t for _, t in pairs], tlen, toff, Ltb)
                if tp is not None:
                    return None, None, qlen, tlen, toff, Lq, Ltb, qp, tp
        if native.lib is not None:
            qb, qp = native.build_and_pack(
                [q for q, _ in pairs], qlen, None, Lq)
            tbuf, tp = native.build_and_pack(
                [t for _, t in pairs], tlen, toff, Ltb)
            if qp is None or tp is None:
                qp = tp = None
            return qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp

        pad = b"\0" * (Ltb + 1)
        toffs = toff.tolist()
        qb = np.frombuffer(
            b"".join(q.ljust(Lq, b"\0") for q, _ in pairs), np.uint8
        ).reshape(B, Lq)
        # clamp/truncate only matters for overflow pairs (toff < 0 when the
        # window can't fit); their buffer content is never used
        tbuf = np.frombuffer(
            b"".join(
                (pad[: max(toffs[i], 0)] + t)[:Ltb].ljust(Ltb, b"\0")
                for i, (_, t) in enumerate(pairs)
            ),
            np.uint8,
        ).reshape(B, Ltb)
        qp = self._pack2(qb, np.zeros_like(qlen), qlen)
        tp = self._pack2(tbuf, toff, toff + tlen) if qp is not None else None
        if tp is None:
            qp = tp = None
        return qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp

    @staticmethod
    def _pack2(arr: np.ndarray, lo: np.ndarray, hi: np.ndarray):
        """2-bit-pack a byte matrix whose in-bounds ([lo, hi) per row)
        bytes are pure ACGT (4 bases/byte, little pairs first); returns
        None when other symbols are present in bounds. Pad bytes pack as
        code 0 and are re-zeroed by the device unpack masks. Host->device
        uploads shrink 4x.

        Fast path (the pipeline hot loop — this runs per submitted
        batch): padded rows are all-\\0 outside [lo, hi), so two scalar
        checks prove every nonzero byte is in-bounds ACGT and the pack
        needs no per-cell bounds mask.  Inputs with out-of-bounds junk
        or in-bounds \\0 take the exact masked path."""
        codes = _ACGT_LUT0[arr]  # \0 pads -> 0, non-ACGT -> 255
        # PER-ROW nonzero counts: a batch-global sum could balance an
        # in-bounds NUL in one row against out-of-bounds junk in another
        # and silently pack the NUL as 'A'
        row_nz = np.count_nonzero(arr, axis=1)
        if (np.array_equal(row_nz, np.clip(hi - lo, 0, None))
                and int(codes.max(initial=0)) <= 3):
            # every nonzero byte is in-bounds ACGT; pads are code 0
            c = codes.reshape(arr.shape[0], -1, 4)
            return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
                    | (c[:, :, 3] << 6)).astype(np.uint8)
        codes = _ACGT_LUT[arr]
        pos = np.arange(arr.shape[1], dtype=np.int32)
        inb = (pos >= lo[:, None]) & (pos < hi[:, None])
        codes = np.where(inb, codes, 0)
        if codes.max(initial=0) > 3:
            return None
        c = codes.reshape(arr.shape[0], -1, 4)
        return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
                | (c[:, :, 3] << 6)).astype(np.uint8)

    def align_batch(
        self,
        pairs: Sequence[Tuple[bytes, bytes]],
        fallback: bool = True,
    ) -> List[Optional[AlignmentResult]]:
        """Align a batch of (query, target) pairs; returns results in order.

        Pairs that overflow the configured windows are completed by the
        exact host oracle when ``fallback`` is True, else returned as
        ``None`` (so a pipeline can re-batch them with larger caps).

        Raises EmptySeqError/SeqTooLongError on invalid pairs, matching
        the reference's guards (wfa.go:204-209).
        """
        for q, t in pairs:
            if len(q) == 0 or len(t) == 0:
                raise EmptySeqError("wfa: invalid empty sequence")
            if len(q) > MAX_SEQ_LEN or len(t) > MAX_SEQ_LEN:
                raise SeqTooLongError(
                    f"wfa: sequences longer than {MAX_SEQ_LEN} are not supported"
                )

        return self.finish_batch(self.submit_batch(pairs), fallback)

    def submit_batch(self, pairs: Sequence[Tuple[bytes, bytes]],
                     prepacked=None):
        """Enqueue a batch on the device without blocking.

        Returns an opaque handle for :meth:`finish_batch`.  Submitting
        many batches before finishing any hides the host↔device dispatch
        latency (the results stay on device until fetched).
        ``prepacked`` (from :meth:`_pack_all` on the same pairs) lets a
        pipeline pack on one thread while another uploads (single-device
        engines only — mesh submits pad the batch before packing).
        """
        pairs = list(pairs)
        if self.mesh is not None:
            # shard_map needs the batch divisible by the mesh; pad with
            # trivial pairs whose results are dropped by the zip decode
            n_dev = self.mesh.devices.size
            short = (-len(pairs)) % n_dev
            pairs_padded = pairs + [(b"A", b"A")] * short
        else:
            pairs_padded = pairs
        B = len(pairs_padded)
        if prepacked is not None and self.mesh is None:
            qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = prepacked
        else:
            qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = self._pack_all(
                pairs_padded, need_raw=False)
        packed = tp is not None
        # two uploads instead of five: sequences ride one byte matrix,
        # the three per-pair scalars one [B, 3] int32 (each transfer
        # pays a fixed latency)
        seq = np.concatenate(
            [qp if packed else qb, tp if packed else tbuf], axis=1)
        lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
        host_args = (seq, lens)
        if self.mesh is not None and jax.process_count() > 1:
            # multi-host: a jitted shard_map over a global mesh needs
            # global jax.Arrays, not process-local numpy (every process
            # runs the same input, so each can serve any shard index)
            args = _global_args(self.mesh, host_args)
        else:
            args = tuple(jnp.asarray(a) for a in host_args)
        with DISPATCH_LOCK:  # jit dispatch + output slicing (see lock doc)
            if self.mesh is not None:
                from .parallel import dp_align_full_fn

                out = dp_align_full_fn(
                    self.cfg, self.mesh, B, Lq, Ltb, packed)(*args)
            else:
                out = _align_full2(
                    *args, cfg=self.cfg, B=B, Lq=Lq, Ltb=Ltb,
                    packed=packed, flat=True,
                )
            return self._queue_fetch(pairs, out)

    def _queue_fetch(self, pairs, out):
        """Queue device->host copies for a dispatched batch's outputs.

        Small outputs copy now so they overlap the next batch's compute
        instead of serializing at fetch time.  The token buffer
        ('toks'/'buf', whichever this path emits) is SPECULATIVELY
        prefetched at an adaptive extent: the used extent is only known
        from meta (host-side), but batches of one workload are alike —
        prefetching the previous batch's extent (plus slack) makes the
        drain need zero extra device round trips in the common case;
        batches that outrun the guess fetch the remainder in
        finish_small (rare; the guess self-adjusts)."""
        big0 = "mtb" if "mtb" in out else ("mt" if "mt" in out else None)
        if big0 is not None:
            # a 1-element copy enqueued BEFORE the output copies lands
            # the moment execution completes — wait_exec() blocks on it
            # so a pipeline can release its modeled execution-arena
            # reservation without waiting for the (bandwidth-bound)
            # output stream
            t = out[big0]
            tiny = t[:1] if t.ndim == 1 else t[:1, :1]
            tiny.copy_to_host_async()
            out["_tiny"] = tiny
        for k, a in out.items():
            if k not in ("buf", "toks", "mt", "mtb", "lg", "_tiny"):
                a.copy_to_host_async()
        if "mtb" in out:
            # byte-stream layout: meta bytes lead the uint8 token stream
            # ("mtb"); full-width long tokens ride a second tensor
            # ("lg") whose async copy pipelines with the first
            mtb, lg = out["mtb"], out["lg"]
            hd = mtb.shape[0] - lg.shape[0]  # meta byte count
            gb = self._tok_guess.get("mtb")
            if gb is None:
                # cold start: prefetch a plausible token extent rather
                # than meta-only (a miss costs one remainder round trip
                # AND compiles a fresh trim-slice program, ~0.5 s)
                gb = _coarse(64 * max(len(pairs), 1))
            spec_b = mtb[:min(mtb.shape[0], hd + gb)]
            spec_b.copy_to_host_async()
            gl = self._tok_guess.get("lg")
            spec_l = None
            if gl:
                spec_l = lg[:min(lg.shape[0], gl)]
                spec_l.copy_to_host_async()
            return pairs, out, (spec_b, spec_l)
        big = ("mt" if "mt" in out
               else "toks" if "toks" in out else "buf")
        guess = self._tok_guess.get(big)
        spec = None
        if big == "mt":
            # the merged meta|tokens tensor: the prefetch always covers
            # at least the meta columns (finish_small reads trim extents
            # from the prefetched slice — no separate meta fetch).
            # 1-D = flat cross-pair-packed tokens (single-device), 2-D =
            # row layout (shard_map outputs concatenate along the batch)
            mt = out["mt"]
            nm = len(META_COLS)
            if mt.ndim == 1:
                B = len(pairs)
                hd = nm * B
                n = hd if guess is None else min(mt.shape[0], hd + guess)
                spec = mt[:n]
            else:
                cols = (nm if guess is None
                        else min(mt.shape[1], nm + guess))
                spec = mt[:, :cols]
            spec.copy_to_host_async()
        elif guess is not None:
            if big == "toks":
                spec = out["toks"][:, : min(out["toks"].shape[1], guess)]
            else:
                spec = out["buf"][: min(out["buf"].shape[0], guess)]
            spec.copy_to_host_async()
        return pairs, out, spec

    def finish_batch(self, handle, fallback: bool = True):
        """Fetch a submitted batch's results and decode them."""
        return self.finish_tokens(self.finish_small(handle), fallback)

    @staticmethod
    def wait_exec(handle) -> None:
        """Block until the submitted batch's program has finished
        executing on device (the 1-element marker copy enqueued before
        the output copies lands as soon as execution completes) —
        cheap next to waiting for the full output stream."""
        out = handle[1]
        tiny = out.get("_tiny")
        if tiny is not None:
            _host_fetch(tiny)
            return
        # layouts without a marker: a fresh 1-element fetch of any
        # output still only lands post-execution
        a = next(iter(out.values()))
        with DISPATCH_LOCK:
            t = a[:1] if a.ndim == 1 else a[:1, :1]
        _host_fetch(t)

    def finish_small(self, handle):
        """Fetch everything except the token buffer and queue the token
        fetch for whatever the speculative prefetch missed; returns a
        handle for finish_tokens.

        Splitting the fetch lets a pipeline start the (latency-bound)
        token-slice dispatch of one batch while others still compute."""
        pairs, dev, spec = handle
        if "mtb" in dev:
            # byte-stream layout: ONE uint8 fetch covers the meta bytes
            # and (in the common case) the whole used byte-token extent;
            # the long-token stream fetches at its own guessed extent
            spec_b, spec_l = spec
            B = len(pairs)
            nm = len(META_COLS)
            hd = dev["mtb"].shape[0] - dev["lg"].shape[0]
            mb = hd // (nm * B) if B else 2
            head = _host_fetch(spec_b)
            mraw = head[:hd].reshape(B, nm, mb).astype(np.int64)
            meta = sum(
                mraw[:, :, i] << (8 * i) for i in range(mb)
            ).astype(np.int32)
            out = {"meta": meta, "_b_head": head[hd:]}
            tot_b = int(meta[:, M_TRIM].astype(np.int64).sum()) if B else 0
            tot_l = int(meta[:, M_LONG].astype(np.int64).sum()) if B else 0
            self._tok_guess["mtb"] = _coarse(max(tot_b, 1) * 9 // 8)
            self._tok_guess["lg"] = _coarse(max(tot_l, 1) * 9 // 8)
            need_b = min(dev["mtb"].shape[0] - hd, _coarse(max(tot_b, 1)))
            have_b = head.shape[0] - hd
            need_l = min(dev["lg"].shape[0], _coarse(max(tot_l, 1)))
            have_l = spec_l.shape[0] if spec_l is not None else 0
            trim_b = trim_l = None
            with DISPATCH_LOCK:
                if have_b < need_b:
                    trim_b = dev["mtb"][hd + have_b : hd + need_b]
                    trim_b.copy_to_host_async()
                if have_l < need_l:
                    trim_l = dev["lg"][have_l:need_l]
                    trim_l.copy_to_host_async()
            return pairs, dev, out, "mtb", spec, (trim_b, trim_l)
        big = ("mt" if "mt" in dev
               else "toks" if "toks" in dev else "buf")
        if big == "mt":
            # merged meta|tokens: ONE fetch covers the scalars and (in
            # the common case) the whole used token extent
            nm = len(META_COLS)
            head = _host_fetch(spec)
            if head.ndim == 1:
                # flat layout: [B*nm meta | cross-pair-packed tokens];
                # the guess tracks the TOTAL used token count
                B = len(pairs)
                hd = nm * B
                out = {"meta": head[:hd].reshape(B, nm),
                       "_mt_head": head[hd:]}
                tot = (int(out["meta"][:, M_TRIM].astype(np.int64).sum())
                       if B else 0)
                self._tok_guess[big] = _coarse(max(tot, 1) * 5 // 4)
                need = min(dev["mt"].shape[0] - hd,
                           _coarse(max(tot, 1)))
                have = head.shape[0] - hd
                if have >= need:
                    trim = None
                else:
                    with DISPATCH_LOCK:
                        trim = dev["mt"][hd + have : hd + need]
                        trim.copy_to_host_async()
                return pairs, dev, out, big, spec, trim
            out = {"meta": head[:, :nm], "_mt_head": head[:, nm:]}
            n = int(out["meta"][:, M_TRIM].max()) if len(pairs) else 0
            self._tok_guess[big] = _coarse(max(n, 1) * 5 // 4, 64)
            cols = min(dev["mt"].shape[1] - nm, _coarse(max(n, 1), 64))
            have = head.shape[1] - nm
            if have >= cols:
                trim = None
            else:
                with DISPATCH_LOCK:
                    trim = dev["mt"][:, nm + have : nm + cols]
                    trim.copy_to_host_async()
            return pairs, dev, out, big, spec, trim
        small = {k: a for k, a in dev.items() if k != big}
        out = {k: _host_fetch(a) for k, a in small.items()}
        # fetch only the used token columns/rows (rounded so slice
        # programs are reused); the rest is all-zero
        n = int(out["meta"][:, M_TRIM].max()) if len(pairs) else 0
        # adapt the speculative-prefetch extent to the workload (slack so
        # batch-to-batch jitter doesn't force remainder fetches)
        self._tok_guess[big] = ((max(n, 1) * 5 // 4 + 31) // 32) * 32
        with DISPATCH_LOCK:
            if big == "toks":
                cols = min(dev["toks"].shape[1],
                           ((max(n, 1) + 63) // 64) * 64)
                if spec is not None and spec.shape[1] >= min(
                        cols, dev["toks"].shape[1]):
                    trim = None  # prefetch covers the used extent
                elif spec is not None:
                    trim = dev["toks"][:, spec.shape[1] : cols]
                else:
                    trim = dev["toks"][:, :cols]
            else:
                rows = min(dev["buf"].shape[0],
                           ((max(n, 1) + 31) // 32) * 32)
                if spec is not None and spec.shape[0] >= min(
                        rows, dev["buf"].shape[0]):
                    trim = None
                elif spec is not None:
                    trim = dev["buf"][spec.shape[0] : rows]
                else:
                    trim = dev["buf"][:rows]
            if trim is not None:
                trim.copy_to_host_async()
        return pairs, dev, out, big, spec, trim

    def finish_tokens(self, handle2, fallback: bool = True):
        pairs, dev, out, big, spec, trim = handle2
        if big == "mtb":
            spec_b, spec_l = spec
            trim_b, trim_l = trim
            bts = out.pop("_b_head")
            if trim_b is not None:
                bts = np.concatenate([bts, _host_fetch(trim_b)])
            lparts = [_host_fetch(a) for a in (spec_l, trim_l)
                      if a is not None]
            longs = (np.concatenate(lparts) if lparts
                     else np.zeros(0, np.int16))
            meta = out["meta"]
            ends = np.cumsum(meta[:, M_TRIM].astype(np.int64))
            ends_l = np.cumsum(meta[:, M_LONG].astype(np.int64))
            ntot = int(ends[-1]) if len(ends) else 0
            ltot = int(ends_l[-1]) if len(ends_l) else 0
            b = bts[:ntot]
            lg = longs[:ltot]
            # reconstruct the full-width token stream: byte = code<<5|run,
            # placeholder bytes (224) splice the long stream in order
            shift = 12 if lg.dtype == np.int16 else 28
            toks = (((b >> 5).astype(np.int32) << shift)
                    | (b & 31)).astype(lg.dtype)
            ph = b == 224
            toks[ph] = lg
            out["toks_flat"] = (toks, ends)
            # edit-only mode (same gate the jit used): decode needs the
            # sequences to reconstruct match runs
            out["_edit"] = (self.cfg.global_alignment
                            and os.environ.get("WFA_EDIT_TOKENS") != "0")
            for a in dev.values():
                a.delete()
            for a in (spec_b, spec_l, trim_b, trim_l):
                if a is not None:
                    a.delete()
            return self._finish(pairs, out, fallback)
        if big == "mt":
            toks = out.pop("_mt_head")
            if trim is not None:
                toks = np.concatenate(
                    [toks, _host_fetch(trim)], axis=toks.ndim - 1)
            if toks.ndim == 1:  # flat: split per pair by M_TRIM extents
                ends = np.cumsum(
                    out["meta"][:, M_TRIM].astype(np.int64))
                out["toks_flat"] = (toks, ends)
            else:
                out["toks"] = toks
        else:
            parts = [_host_fetch(a) for a in (spec, trim) if a is not None]
            axis = 1 if big == "toks" else 0
            out[big] = parts[0] if len(parts) == 1 else np.concatenate(
                parts, axis=axis)
        # release the device buffers eagerly — retry tiers of long
        # sequences allocate multi-GB programs and must not stack up
        # behind Python GC
        for a in dev.values():
            a.delete()
        if spec is not None:
            spec.delete()
        if trim is not None:
            trim.delete()
        return self._finish(pairs, out, fallback)

    # -- host-side completion -------------------------------------------------

    def _finish(self, pairs, out, fallback: bool) -> List[Optional[AlignmentResult]]:
        """Decode device op tokens into AlignmentResults (reverse + merge +
        stats happen in AlignmentResult.process, as in the reference)."""

        results: List[Optional[AlignmentResult]] = []
        if "mt" in out:  # merged meta|tokens (direct finish of a raw dict)
            nm = len(META_COLS)
            out = {"meta": out["mt"][:, :nm], "toks": out["mt"][:, nm:]}
        # Token streams arrive either device-compacted ("toks") or as the
        # raw three-part stream (start token, iteration-major loop buffer,
        # tail) to assemble here.  Stats were computed on device; op
        # decoding is lazy (first .ops access).
        if "toks_flat" in out:
            # manual view slicing: np.split's array_split machinery
            # costs ~5 ms per 2048-pair batch
            flat_toks, ends = out["toks_flat"]
            el = ends.tolist()
            buf = [flat_toks[a:b] for a, b in zip([0] + el[:-1], el)]
        elif "toks" in out:
            buf = out["toks"]
        else:
            # size by the device tensors, not len(pairs): mesh-padded
            # batches carry extra rows that the zip below simply drops
            Bd = out["tok0"].shape[0]
            buf = np.concatenate(
                [
                    out["tok0"][:, None],
                    np.transpose(out["buf"], (1, 0, 2)).reshape(Bd, -1),
                    out["tail"],
                ],
                axis=1,
            )
        ga = self.cfg.global_alignment
        meta = out["meta"]
        edit = out.get("_edit", False)
        # bulk tolists + a zip-driven loop: the per-pair result build
        # is pipeline host-CPU hot path
        scores = meta[:, M_SCORE].tolist()
        ovfs = meta[:, M_OVF].tolist()
        from_device = AlignmentResult.from_device
        append = results.append
        oracle = self._oracle
        for (q, t), score, ovf, toks in zip(pairs, scores, ovfs, buf):
            if ovf:
                append(oracle.align(q, t) if fallback else None)
            else:
                append(from_device(
                    ga, score, (toks, q, t) if edit else toks))
        return results
