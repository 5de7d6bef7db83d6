"""On-device CIGAR backtrace + semi-global end finder.

The reference's backtrace (wfa.go:703-983) is a sequential pointer chase
through the wavefront history.  Running it host-side would require
shipping the whole packed history off-device (hundreds of MB per batch);
instead the chase runs *on device*: all B pairs step in lockstep through
a ``lax.while_loop``, each iteration doing ONE one-cell gather per pair
from the device-resident *backtrace-aux* tensor, and emitting
(op, run-length) tokens into dense per-iteration buffer slots (no
scatters).  Only those token buffers (~KB/pair) ever leave the device.

Layout: the aux tensor is ``int32[3, S, B, K]`` (components M=0, I=1,
D=2) with a fixed per-pair window origin ``k0[b]`` (column j holds
diagonal ``k0 + j`` at every score).  Each aux cell packs
``offset0 << 3 | tag`` (0 = absent): the cell's stored tag plus the
pre-extension offset that the reference's backtrace would recompute at
that cell (branch chosen by the cell's own tag: InsertExt -> I-rule,
DeleteExt -> D-rule, else the default M-rule; wfa.go:757-827).  The
forward engines bake these values from the same raw source reads the
reference recompute performs — the source rows are frozen by the time
next() reads them, so the values are identical by construction.

Two fusions make the chase one gather per step: the offset0 recompute is
precomputed per cell (above), and the "read tag of the new cell"
(wfa.go:915-920) is deferred into the NEXT iteration's gather — the aux
value at the stepped-into cell carries both its tag and its offset0.

Outputs are bit-identical to the host backtrace: the loop is an exact
port including break order, ``previousFromM`` handling and the
pre-extension offset recomputation from raw neighbor cells
(wfa.go:757-827).

Op-token encoding: ``code << 28 | run_length`` with codes
0=M 1=X 2=I 3=D 4=H; a zero token is an empty slot (host decode skips
zeros, so run lengths are never zero).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from .constants import (
    T_DEL_EXT,
    T_DEL_OPEN,
    T_INS_EXT,
    T_INS_OPEN,
    T_MATCH,
    T_MISMATCH,
    TYPE_BITS,
)

_BIG = np.int32(1 << 30)

CODE_M, CODE_X, CODE_I, CODE_D, CODE_H = 0, 1, 2, 3, 4
# gap-EXTENSION variants used by the edit-only token mode: the host
# must know that no match run can precede an extension step (the cell
# between two extension ops is an I/D-component cell, which never
# extends), so InsertExt/DeleteExt ship distinct codes.  Decoders
# normalize 5 -> I, 6 -> D.
CODE_IE, CODE_DE = 5, 6
OP_CHARS = "MXIDH"
# tag (0..7) -> op code; tags 1,2 -> I; 3,4 -> D; 5 -> X; 6 -> M
_TAG2CODE = np.array([7, CODE_I, CODE_I, CODE_D, CODE_D, CODE_X, CODE_M, 7],
                     dtype=np.int32)
# split-extension variant (edit-only mode): IE/DE keep their own codes
_TAG2CODE_SPLIT = np.array(
    [7, CODE_I, CODE_IE, CODE_D, CODE_DE, CODE_X, CODE_M, 7],
    dtype=np.int32)

COMP_M, COMP_I, COMP_D = 0, 1, 2


def iter_capacity(s_cap: int, penalties) -> int:
    """Upper bound on backtrace loop iterations: every step lowers the
    score by at least min(mismatch, gap_ext) (wfa.go:884-909)."""
    step = max(1, min(penalties.mismatch, penalties.gap_ext))
    return s_cap // step + 4


def end_finder(hist_m, k0, final_s, qlen, tlen, S, K):
    """Vectorized semi-global end finder (wfa.go:270-375).

    For every existing score row the reference scans k downward from Ak
    and upward from Ak+1, skipping absent cells, failing at the first
    bound-violating cell and succeeding at the first last-row/col cell.
    Equivalently: the nearest *stop* cell in each direction decides.
    ``hist_m`` is the M-component packed-cell history [S, B, K].
    Returns (min_s, last_k) per pair.
    """
    ks = k0[None, :, None] + jnp.arange(K, dtype=jnp.int32)[None, None, :]
    cell = hist_m  # [S, B, K]
    n = qlen[None, :, None]
    m = tlen[None, :, None]
    s_rows = jnp.arange(S, dtype=jnp.int32)[:, None, None]
    okc = (cell > 0) & (s_rows <= final_s[None, :, None])
    h = cell >> TYPE_BITS
    v = h - ks
    viol = (v <= 0) | (v > n) | (h > m)
    elig = ((v == n) & (h >= n)) | ((h == m) & (v >= m))
    stop = okc & (viol | elig)
    succ = okc & ~viol & elig

    Ak = (tlen - qlen)[None, :, None]
    stop_dn = stop & (ks <= Ak)
    k_dn = jnp.max(jnp.where(stop_dn, ks, -_BIG), axis=2)  # [S,B]
    succ_dn = jnp.any(succ & (ks <= Ak) & (ks == k_dn[:, :, None]), axis=2)
    stop_up = stop & (ks >= Ak + 1)
    k_up = jnp.min(jnp.where(stop_up, ks, _BIG), axis=2)
    succ_up = jnp.any(succ & (ks >= Ak + 1) & (ks == k_up[:, :, None]), axis=2)

    row_ok = succ_dn | succ_up  # [S,B]
    s_idx = jnp.arange(S, dtype=jnp.int32)[:, None]
    min_s = jnp.min(jnp.where(row_ok, s_idx, _BIG), axis=0)  # [B]
    found = min_s < _BIG
    sc = jnp.clip(min_s, 0, S - 1)
    up_at = jnp.take_along_axis(succ_up, sc[None, :], 0)[0]
    k_sel = jnp.where(
        up_at,
        jnp.take_along_axis(k_up, sc[None, :], 0)[0],
        jnp.take_along_axis(k_dn, sc[None, :], 0)[0],
    )
    ak = tlen - qlen
    return (
        jnp.where(found, min_s, final_s),
        jnp.where(found, k_sel, ak),
        found,
    )


def device_stats(tok0, buf, tail, token_shift: int = 28):
    """Vectorized AlignmentResult.process stats (wfa_cigar.go:171-211).

    Works directly on the emission-order token stream (tok0, buf rows,
    tail), which is the reverse of the final op order; zero tokens are
    empty slots.  Stats cover merged ops between the first and last M
    run: in emission order that is the span [first M token, last M token],
    and a merged gap region starts wherever an I/D token's previous
    non-empty token (emission order) has a different code.

    Returns (align_len, matches, gaps, gap_regions), each int32[B].
    """
    B = tok0.shape[0]
    toks = jnp.concatenate(
        [tok0[:, None], jnp.transpose(buf, (1, 0, 2)).reshape(B, -1), tail],
        axis=1,
    )  # [B, NS] emission order
    NS = toks.shape[1]
    code = (toks >> token_shift).astype(jnp.int32)
    # normalize the edit-only mode's split extension codes (no-op when
    # the plain table was used)
    code = jnp.where(code == CODE_IE, CODE_I,
                     jnp.where(code == CODE_DE, CODE_D, code))
    run = (toks & ((1 << token_shift) - 1)).astype(jnp.int32)
    nz = toks != 0
    pos = jnp.arange(NS, dtype=jnp.int32)[None, :]

    is_m = nz & (code == CODE_M)
    first_m = jnp.min(jnp.where(is_m, pos, NS), axis=1, keepdims=True)
    last_m = jnp.max(jnp.where(is_m, pos, -1), axis=1, keepdims=True)
    # Go's begin/end default to index 0 when no M exists
    # (wfa_cigar.go:171-187): the span is then the first final-order
    # MERGED op — i.e. the whole trailing emission-order run of non-empty
    # tokens sharing the last token's code, not just the last token.
    has_m = last_m >= 0
    last_nz = jnp.max(jnp.where(nz, pos, -1), axis=1, keepdims=True)
    last_code = jnp.max(
        jnp.where(nz & (pos == last_nz), code, -1), axis=1, keepdims=True)
    mism = nz & (code != last_code)
    last_mism = jnp.max(jnp.where(mism, pos, -1), axis=1, keepdims=True)
    first_trail = jnp.min(
        jnp.where(nz & (pos > last_mism), pos, NS), axis=1, keepdims=True)
    first_m = jnp.where(has_m, first_m, first_trail)
    last_m = jnp.where(has_m, last_m, last_nz)
    span = nz & (pos >= first_m) & (pos <= last_m)

    align_len = jnp.sum(jnp.where(span, run, 0), axis=1)
    matches = jnp.sum(jnp.where(span & (code == CODE_M), run, 0), axis=1)
    is_gap = (code == CODE_I) | (code == CODE_D)
    gaps = jnp.sum(jnp.where(span & is_gap, run, 0), axis=1)

    # previous non-empty token's code without a gather: cummax over
    # pos*8|code packs (monotone in pos), shifted right by one slot
    packp = jnp.where(nz, pos * 8 + code, -1)
    cm = lax.cummax(packp, axis=1)
    prev_pack = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), cm[:, :-1]], axis=1)
    prev_code = prev_pack & 7
    prev_pos = prev_pack >> 3
    prev_in_span = (prev_pack >= 0) & (prev_pos >= first_m)
    region_start = span & is_gap & (~prev_in_span | (prev_code != code))
    gap_regions = jnp.sum(region_start.astype(jnp.int32), axis=1)

    return align_len, matches, gaps, gap_regions


def compact_tokens(tok0, buf, tail, token_shift):
    """Compact the emission-order token stream on device: one stable
    key-value sort moves non-empty tokens to the front of each row
    (order preserved by a position-based key), so the host fetches the
    used prefix instead of the sparse full stream (~2.5x fewer bytes for
    16-bit tokens; ~16x for the int32 long-read path, whose rows are
    mostly empty slots).

    Works for any token width (`lax.sort` carries the tokens alongside
    the int32 key — no packing headroom needed).  Returns
    (toks [B, NS] int16/int32 with trailing zeros, n_tok [B])."""
    B = tok0.shape[0]
    dtype = jnp.int16 if token_shift <= 12 else jnp.int32
    toks = jnp.concatenate(
        [tok0[:, None], jnp.transpose(buf, (1, 0, 2)).reshape(B, -1), tail],
        axis=1,
    ).astype(jnp.int32)  # [B, NS] emission order
    NS = toks.shape[1]
    nz = toks != 0
    pos = jnp.arange(NS, dtype=jnp.int32)[None, :]
    key = jnp.where(nz, pos, NS + pos)
    _, out = lax.sort((jnp.broadcast_to(key, toks.shape), toks),
                      dimension=1, num_keys=1)
    n_tok = jnp.sum(nz, axis=1).astype(jnp.int32)
    return out.astype(dtype), n_tok


def compact_tokens_flat_u8(tok0, buf, tail, token_shift, drop_m=False):
    """Cross-pair byte-stream token compaction: most op runs are short,
    so each token ships as ONE byte ``code << 5 | run`` when ``run <= 31``;
    longer runs ship a placeholder byte (``7 << 5``, code 7 is unused)
    in the byte stream plus the ORIGINAL full-width token in a second
    compacted stream, and the host splices them back by position —
    a bijection on the token stream, so decode is bit-identical.
    Measured ~95 tokens/pair at l=1k e=0.05 with ~10-20 runs > 31:
    ~115 bytes/pair vs 190 for int16 rows (~1.7x less download).

    Returns (bytes_flat [B*NS] uint8, longs_flat [B*NS] int16/int32,
    n_tok [B], n_long [B]); both flats are dense prefixes ordered by
    (pair, emission position) with trailing zeros."""
    B = tok0.shape[0]
    dtype = jnp.int16 if token_shift <= 12 else jnp.int32
    toks = jnp.concatenate(
        [tok0[:, None], jnp.transpose(buf, (1, 0, 2)).reshape(B, -1), tail],
        axis=1,
    ).astype(jnp.int32)
    NS = toks.shape[1]
    flat = toks.reshape(B * NS)
    nz = flat != 0
    code = lax.shift_right_logical(flat, token_shift)
    if drop_m:
        # edit-only mode (global alignment): match runs are fully
        # determined by the edit ops plus the sequences (extension is
        # greedy-maximal, so every match run equals the LCP at its
        # junction) — the host reconstructs them
        # (AlignmentResult._decode_edit_tokens), and the download
        # shrinks ~2x again on realistic error rates
        nz = nz & (code != CODE_M)
    run = flat & ((1 << token_shift) - 1)
    long = nz & (run > 31)
    byte_plane = jnp.where(long, 224, (code << 5) | run)
    byte_plane = jnp.where(nz, byte_plane, 0)
    pos = jnp.arange(B * NS, dtype=jnp.int32)
    key_b = jnp.where(nz, pos, np.int32(B * NS))
    _, bytes_flat = lax.sort((key_b, byte_plane), dimension=0, num_keys=1)
    key_l = jnp.where(long, pos, np.int32(B * NS))
    _, longs_flat = lax.sort((key_l, jnp.where(long, flat, 0)),
                             dimension=0, num_keys=1)
    nz2 = nz.reshape(B, NS)
    n_tok = jnp.sum(nz2, axis=1).astype(jnp.int32)
    n_long = jnp.sum(long.reshape(B, NS), axis=1).astype(jnp.int32)
    return (bytes_flat.astype(jnp.uint8), longs_flat.astype(dtype),
            n_tok, n_long)


def device_backtrace(
    aux, start_cell, k0, start_s, start_k, qlen, tlen, active0,
    *, penalties, global_alignment: bool, S: int, K: int,
    token_shift: int = 28, split_ext_codes: bool = False,
):
    """Exact device port of the backtrace loop (wfa.go:703-983).

    ``aux`` is the combined backtrace-aux tensor: per cell
    ``offset0 << 3 | tag`` where offset0 is the branch-selected
    pre-extension offset the reference recomputes at that cell
    (wfa.go:757-827) — baked by the forward pass, making each chase step
    ONE one-cell gather.  Layout is ``[3, S, B, K]``, reshaped to a 2-D
    leading-dims-only view so the per-step gather is a (row, column)
    2-D gather.  ``start_cell`` is the raw
    packed start M cell (GetRaw at (start_s, start_k), wfa.go:738).

    Returns (tok0 [B], buf [it_cap, B, 2], tail [B, 4], q_begin, q_end,
    t_begin, t_end): op tokens in emission order tok0, buf[0], buf[1], …,
    tail, with zero = empty slot.  The buffer is iteration-major so the
    loop writes one leading-dim row per step (no scatters, no dynamic
    lane offsets).
    """
    B = qlen.shape[0]
    x = np.int32(penalties.mismatch)
    oe = np.int32(penalties.gap_open + penalties.gap_ext)
    e = np.int32(penalties.gap_ext)
    semi = not global_alignment
    it_cap = iter_capacity(S, penalties)
    # 16-bit tokens when run lengths fit 2^token_shift (halves the
    # device->host token traffic)
    tok_dtype = jnp.int16 if token_shift <= 12 else jnp.int32

    def _pack(code, n):
        return (code << token_shift) | n

    # leading-dims-only reshape: stays a view of the stored layout
    # (a full 1-D flatten would force a multi-GB relayout copy)
    flat = aux.reshape(3 * S * B, K)
    bidx = jnp.arange(B, dtype=jnp.int32)
    code_tab = jnp.asarray(
        _TAG2CODE_SPLIT if split_ext_codes else _TAG2CODE)

    def read_aux(s, comp, k):
        """One-cell aux gather at (s[B], comp[B], k[B]): returns
        (offset0, tag, found)."""
        j = k - k0
        ok = (s >= 0) & (s < S) & (j >= 0) & (j < K)
        sc = jnp.clip(s, 0, S - 1)
        jc = jnp.clip(j, 0, K - 1)
        cell = flat[(comp * S + sc) * B + bidx, jc].astype(jnp.int32)
        found = ok & (cell > 0)
        cell = jnp.where(found, cell, 0)
        off = cell >> TYPE_BITS
        return off, cell & ((1 << TYPE_BITS) - 1), found

    # ---- start point (wfa.go:738-750); existence deliberately unchecked.
    raw = start_cell
    tag = raw & ((1 << TYPE_BITS) - 1)
    h = raw >> TYPE_BITS
    v = h - start_k

    buf = jnp.zeros((it_cap, B, 2), tok_dtype)
    fl_i = h < tlen
    fl_h = (~fl_i) & (v < qlen)
    tok0 = jnp.where(
        active0 & (fl_i | fl_h),
        _pack(jnp.where(fl_i, CODE_I, CODE_H),
              jnp.maximum(jnp.where(fl_i, tlen - h, qlen - v), 0)),
        0,
    ).astype(tok_dtype)

    alive = active0 & (v > 0) & (h > 0)
    pfm = jnp.ones((B,), bool)  # previousFromM
    first = jnp.ones((B,), bool)  # firstMatch
    qe = jnp.zeros((B,), jnp.int32)
    te = jnp.zeros((B,), jnp.int32)
    qb0 = jnp.zeros((B,), jnp.int32)
    tb0 = jnp.zeros((B,), jnp.int32)
    s = start_s
    k = start_k
    # component of the pending tag read — M until an Ext step says I/D
    comp = jnp.full((B,), COMP_M, jnp.int32)
    pending = jnp.zeros((B,), bool)  # a step happened; tag read deferred
    it = jnp.int32(0)

    def body(c):
        (s, k, h, v, tag, comp, pending, pfm, first, qe, te, qb0, tb0, buf,
         alive, it) = c
        smis = s - x
        sgo = s - oe
        sge = s - e

        # ONE one-cell gather: the aux value at (s, k) in the component
        # the previous step selected carries BOTH the cell tag
        # (wfa.go:915-920, read deferred from the last step) and the
        # branch-selected pre-extension offset0 (wfa.go:757-827).
        offset0, tag_new, tag_ok = read_aux(s, comp, k)
        die0 = alive & pending & ~tag_ok
        tag = jnp.where(pending & tag_ok, tag_new, tag)
        alive = alive & ~die0

        is_ie = tag == T_INS_EXT
        is_de = tag == T_DEL_EXT
        # offset0 == 0 covers both the reference's from-itself break and
        # its offset0 == 0 break (wfa.go:819-827)
        die = offset0 == 0
        cont = alive & ~die

        # traceback matches (wfa.go:832-869)
        nmatch = h - offset0
        emit1 = cont & pfm & (nmatch > 0)
        set_end = emit1 & first
        te = jnp.where(set_end, h, te)
        qe = jnp.where(set_end, v, qe)
        first = first & ~emit1
        tok_m = jnp.where(emit1, _pack(CODE_M, jnp.maximum(nmatch, 0)), 0)

        upd_hv = cont & pfm
        h = jnp.where(upd_hv, offset0, h)
        v = jnp.where(upd_hv, h - k, v)

        is_match = tag == T_MATCH
        set_b1 = upd_hv & is_match
        set_b2 = upd_hv & (~is_match) & (nmatch > 0)
        tb0 = jnp.where(set_b1, h, jnp.where(set_b2, h + 1, tb0))
        qb0 = jnp.where(set_b1, v, jnp.where(set_b2, v + 1, qb0))

        die2 = upd_hv & ((h <= 0) | (v <= 0))
        cont2 = cont & ~die2

        # record the current op (wfa.go:871-874)
        tok_op = jnp.where(cont2, _pack(code_tab[tag], jnp.int32(1)), 0)
        toks = jnp.stack([tok_m, tok_op], axis=1).astype(tok_dtype)
        buf = lax.dynamic_update_slice(buf, toks[None], (it, 0, 0))

        die3 = cont2 & semi & ((h == 1) | (v == 1))
        cont3 = cont2 & ~die3

        # step to the source cell (wfa.go:884-909)
        is_mis = tag == T_MISMATCH
        is_io = tag == T_INS_OPEN
        is_do = tag == T_DEL_OPEN
        valid_tag = is_mis | is_io | is_ie | is_do | is_de

        step = cont3 & valid_tag
        s_n = jnp.where(is_mis, smis, jnp.where(is_io | is_do, sgo, sge))
        k_n = k + jnp.where(is_io | is_ie, -1, jnp.where(is_do | is_de, 1, 0))
        h_n = h + jnp.where(is_mis | is_io | is_ie, -1, 0)
        s = jnp.where(step, s_n, s)
        k = jnp.where(step, k_n, k)
        h = jnp.where(step, h_n, h)
        v = jnp.where(step, h - k, v)
        pfm = jnp.where(step, ~(is_ie | is_de), pfm)
        comp = jnp.where(
            step,
            jnp.where(is_ie, COMP_I, jnp.where(is_de, COMP_D, COMP_M)),
            comp,
        )

        pending = step
        alive = step & (v > 0) & (h > 0) & (it < it_cap - 1)
        return (s, k, h, v, tag, comp, pending, pfm, first, qe, te, qb0,
                tb0, buf, alive, it + 1)

    def cond(c):
        return jnp.any(c[14])

    (s, k, h, v, tag, comp, pending, pfm, first, qe, te, qb0, tb0, buf,
     alive, it) = lax.while_loop(
        cond, body,
        (s, k, h, v, tag, comp, pending, pfm, first, qe, te, qb0, tb0, buf,
         alive, it),
    )

    # lanes that stepped in their final iteration exited with the tag read
    # still pending; the reference updates the tag before its loop check
    # (wfa.go:915-920), so the tail below must see it — apply it now.
    _, tag_p, ok_p = read_aux(s, comp, k)
    appl = pending & ok_p
    tag = jnp.where(appl, tag_p, tag)

    # ---- the last one (wfa.go:930-968), one-shot masked tail
    tl = active0 & (h > 0) & (v > 0)
    nm = jnp.minimum(h, v) - 1
    e1 = tl & (nm > 0)
    set_end = e1 & first
    te = jnp.where(set_end, h, te)
    qe = jnp.where(set_end, v, qe)
    first = first & ~e1
    tok_a = jnp.where(e1, _pack(CODE_M, jnp.maximum(nm, 0)), 0)
    h = jnp.where(e1, h - nm, h)
    v = jnp.where(e1, v - nm, v)
    is_match = tag == T_MATCH
    tb0 = jnp.where(e1, jnp.where(is_match, h, h + 1), tb0)
    qb0 = jnp.where(e1, jnp.where(is_match, v, v + 1), qb0)
    e1b = tl & (nm <= 0) & is_match
    tb0 = jnp.where(e1b, h, tb0)
    qb0 = jnp.where(e1b, v, qb0)
    set_end2 = e1b & first
    te = jnp.where(set_end2, h, te)
    qe = jnp.where(set_end2, v, qe)
    tok_b = jnp.where(tl, _pack(code_tab[tag], jnp.int32(1)), 0)

    # leading flanks (wfa.go:970-976)
    ev = active0 & (v > 1)
    tok_c = jnp.where(ev, _pack(CODE_H, jnp.maximum(v - 1, 0)), 0)
    eh = active0 & (h > 1)
    tok_d = jnp.where(eh, _pack(CODE_I, jnp.maximum(h - 1, 0)), 0)

    tail = jnp.stack([tok_a, tok_b, tok_c, tok_d], axis=1).astype(tok_dtype)

    # `it` = loop iterations actually executed (max path length over the
    # batch): rows of `buf` beyond it are all-zero, so the host need only
    # fetch buf[:it]
    return tok0, buf, tail, it, qb0, qe, tb0, te
