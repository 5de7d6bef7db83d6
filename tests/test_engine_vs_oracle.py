"""Device engine vs oracle: bit-identical scores, CIGARs, coords, stats.

The batched JAX engine must agree with the exact scalar oracle on every
observable output, for global and semi-global modes, with and without
wf-adaptive reduction, across mixed-length batches.
"""

import random

import pytest

from wfa_tpu import AdaptiveReductionOption, Options, Penalties, OracleAligner
from wfa_tpu.engine import BatchAligner

BASES = "ACGT"


def mutate(rng, seq, rate):
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 3:
            out.append(rng.choice(BASES))
        elif r < 2 * rate / 3:
            pass
        elif r < rate:
            out.append(ch)
            out.append(rng.choice(BASES))
        else:
            out.append(ch)
    return "".join(out) or rng.choice(BASES)


def random_pairs(rng, count, max_len=90):
    pairs = []
    for _ in range(count):
        n = rng.randint(1, max_len)
        q = "".join(rng.choice(BASES) for _ in range(n))
        t = mutate(rng, q, rng.choice([0.0, 0.02, 0.05, 0.15, 0.4, 0.9]))
        pairs.append((q.encode(), t.encode()))
    return pairs


def assert_same(res_e, res_o, q, t, ctx=""):
    assert res_e.score == res_o.score, f"{ctx} score: q={q!r} t={t!r}"
    assert res_e.cigar(False) == res_o.cigar(False), (
        f"{ctx} cigar: q={q!r} t={t!r} engine={res_e.cigar(False)} "
        f"oracle={res_o.cigar(False)}"
    )
    for attr in ("q_begin", "q_end", "t_begin", "t_end", "align_len",
                 "matches", "gaps", "gap_regions"):
        assert getattr(res_e, attr) == getattr(res_o, attr), (
            f"{ctx} {attr}: q={q!r} t={t!r}"
        )


GOLDEN_PAIRS = [
    (b"ACCATACTCG", b"AGGATGCTCG"),
    (b"AGCTAGTGTCAATGGCTACTTTTCAGGTCCT", b"AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT"),
    (
        b"ATTGGAAAATAGGATTGGGGTTTGTTTATATTTGGGTTGAGGGATGTCCCACCTTCGTCGTCCTTACGTTTCCGGAAGGGAGTGGTTAGCTCGAAGCCCA",
        b"GATTGGAAAATAGGATGGGGTTTGTTTATATTTGGGTTGAGGGATGTCCCACCTTGTCGTCCTTACGTTTCCGGAAGGGAGTGGTTGCTCGAAGCCCA",
    ),
    (
        b"CCGTAGAGTTAGACACTCGACCGTGGTGAATCCGCGACCACCGCTTTGACGGGCGCTCTACGGTATCCCGCGATTTGTGTACGTGAAGCAGTGATTAAAC",
        b"CCTAGAGTTAGACACTCGACCGTGGTGAATCCGCGATCTACCGCTTTGACGGGCGCTCTACGGTATCCCGCGATTTGTGTACGTGAAGCGAGTGATTAAAC",
    ),
    (b"C", b"C"),
    (b"CG", b"C"),
    (b"ACTG", b"ACTGA"),
    (b"GACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCGACTGCCTCAGTGCCCGGCGCTCAAGCCTCAAGCCTCAAGCCTCAGGTCTCGCAGCCCACCGCATTCACCCGTGACACCGAACTGCATCGCGAACGCATTTCTCGCCGCAGCCGCGCGCACGGGCGACGCGGACTTGCCGGCAAGCCCGCGCGCCGCCCGATGCGCG",
     b"GACTGCCGACTGCCGACTGCCGACTGCCTCAGTGCCCGGCGCTCAAGCCTCAAGCCTCAAGCCTCAGGCCTCAGGCCTCGCAGCCCACCGCATTCACCCGTGACACCGAACTTCATCGCGAACGCATTTCTCGCCGCAGCCGCGCGCGCAGGCGACGCGGACTTGCCGGCAAGCCCGCGCGCCGCCCGATGCGCG"),
]


@pytest.mark.parametrize("adaptive", [None, AdaptiveReductionOption(10, 50, 1)],
                         ids=["plain", "adaptive"])
def test_engine_golden_corpus_global(adaptive):
    opts = Options(True)
    oracle = OracleAligner(Penalties(), opts, adaptive)
    engine = BatchAligner(Penalties(), opts, adaptive, k_win=128, s_cap=256)
    results = engine.align_batch(GOLDEN_PAIRS)
    for (q, t), res_e in zip(GOLDEN_PAIRS, results):
        assert_same(res_e, oracle.align(q, t), q, t, "global")


@pytest.mark.parametrize("adaptive", [None, AdaptiveReductionOption(10, 50, 1)],
                         ids=["plain", "adaptive"])
def test_engine_golden_corpus_semiglobal(adaptive):
    opts = Options(False)
    oracle = OracleAligner(Penalties(), opts, adaptive)
    engine = BatchAligner(Penalties(), opts, adaptive, k_win=512, s_cap=256)
    pairs = GOLDEN_PAIRS + [
        (b"ACGATCTCG", b"CAGGCTCCTCGG"),
        (b"Bioinformatics helps Biology",
         b"We learn bioinformatics to help biologists"),
    ]
    results = engine.align_batch(pairs)
    for (q, t), res_e in zip(pairs, results):
        assert_same(res_e, oracle.align(q, t), q, t, "semi")


@pytest.mark.parametrize("global_alignment", [True, False], ids=["global", "semi"])
@pytest.mark.parametrize("adaptive", [None, AdaptiveReductionOption(10, 50, 1)],
                         ids=["plain", "adaptive"])
def test_engine_random_batches(global_alignment, adaptive):
    rng = random.Random(1234 if global_alignment else 4321)
    opts = Options(global_alignment)
    p = Penalties(4, 6, 2)
    oracle = OracleAligner(p, opts, adaptive)
    engine = BatchAligner(p, opts, adaptive, k_win=256, s_cap=512)
    for batch_i in range(3):
        pairs = random_pairs(rng, 16)
        results = engine.align_batch(pairs)
        for (q, t), res_e in zip(pairs, results):
            assert_same(res_e, oracle.align(q, t), q, t,
                        f"batch{batch_i} {'g' if global_alignment else 's'}")


@pytest.mark.parametrize("penalties", [Penalties(2, 3, 1), Penalties(5, 1, 1),
                                       Penalties(3, 2, 5)])
def test_engine_random_penalties(penalties):
    rng = random.Random(99)
    oracle = OracleAligner(penalties, Options(True), None)
    engine = BatchAligner(penalties, Options(True), None, k_win=256, s_cap=512)
    pairs = random_pairs(rng, 12, max_len=60)
    results = engine.align_batch(pairs)
    for (q, t), res_e in zip(pairs, results):
        assert_same(res_e, oracle.align(q, t), q, t, "pen")


def test_batch_vs_single_equivalence():
    """A pair's result must not depend on its batch-mates (masking)."""
    rng = random.Random(7)
    p = Penalties(4, 6, 2)
    engine = BatchAligner(p, Options(True), AdaptiveReductionOption(10, 50, 1),
                          k_win=256, s_cap=512)
    pairs = random_pairs(rng, 8, max_len=80)
    batched = engine.align_batch(pairs)
    for (q, t), res_b in zip(pairs, batched):
        res_s = engine.align_batch([(q, t)])[0]
        assert res_b.score == res_s.score
        assert res_b.cigar(False) == res_s.cigar(False)


def test_overflow_falls_back_to_oracle():
    """Tiny s_cap forces the device loop to give up; results must still be
    exact via the host fallback."""
    p = Penalties(4, 6, 2)
    engine = BatchAligner(p, Options(True), None, k_win=32, s_cap=16)
    oracle = OracleAligner(p, Options(True), None)
    rng = random.Random(5)
    pairs = random_pairs(rng, 6, max_len=70)
    results = engine.align_batch(pairs)
    for (q, t), res_e in zip(pairs, results):
        assert_same(res_e, oracle.align(q, t), q, t, "fallback")


def test_windowed_stop_tables_match_oracle():
    """w_win windows the per-step stop-table reads (long-sequence mode);
    results must stay bit-identical, with outrun pairs falling back."""
    rng = random.Random(77)
    p = Penalties(4, 6, 2)
    oracle = OracleAligner(p, Options(True), AdaptiveReductionOption())
    pairs = random_pairs(rng, 10, max_len=80)
    for w_win in (2, 4):
        engine = BatchAligner(p, Options(True), AdaptiveReductionOption(),
                              k_win=128, s_cap=256, w_win=w_win)
        for (q, t), res in zip(pairs, engine.align_batch(pairs)):
            assert_same(res, oracle.align(q, t), q, t, f"w{w_win}")


def test_match_free_alignment_stats():
    """Alignments with no M op: the reference's stats span defaults to
    the FIRST merged final-order op (begin=end=0, wfa_cigar.go:171-211),
    i.e. the whole trailing same-op run — not just one token."""
    p = Penalties(4, 6, 2)
    for opts in (Options(True), Options(False)):
        oracle = OracleAligner(p, opts, None)
        engine = BatchAligner(p, opts, None, k_win=128, s_cap=256)
        pairs = [(b"AC", b"GT"), (b"AAAAAA", b"CCCCCC"), (b"A", b"C"),
                 (b"AAAA", b"CC")]
        for (q, t), res in zip(pairs, engine.align_batch(pairs)):
            assert_same(res, oracle.align(q, t), q, t,
                        f"no-M {'g' if opts.global_alignment else 's'}")


def test_small_step_penalties_large_s_cap():
    """Small penalty steps with a huge score cap make the emission
    stream too long for device compaction (the sort would cost more than
    the raw trimmed-rows fetch); the engine must route to the raw token
    path and stay bit-exact."""
    p = Penalties(8, 6, 1)
    oracle = OracleAligner(p, Options(True), None)
    engine = BatchAligner(p, Options(True), None, k_win=64, s_cap=65536)
    rng = random.Random(31)
    pairs = random_pairs(rng, 4, max_len=30)
    for (q, t), res in zip(pairs, engine.align_batch(pairs)):
        assert_same(res, oracle.align(q, t), q, t, "raw-token")


def test_pack2_upload_packing():
    """2-bit upload packing engages for padded DNA rows and refuses rows
    with in-bounds non-ACGT bytes (which must take the raw path)."""
    import numpy as np

    from wfa_tpu.engine import BatchAligner

    arr = np.zeros((2, 8), np.uint8)
    arr[0, :5] = np.frombuffer(b"ACGTT", np.uint8)
    arr[1, :3] = np.frombuffer(b"GGC", np.uint8)
    lo = np.zeros(2, np.int32)
    hi = np.array([5, 3], np.int32)
    pk = BatchAligner._pack2(arr, lo, hi)
    assert pk is not None and pk.shape == (2, 2)
    # in-bounds N poisons the row set; out-of-bounds junk must not
    arr[1, 1] = ord("N")
    assert BatchAligner._pack2(arr, lo, hi) is None
    arr[1, 1] = ord("G")
    arr[0, 6] = ord("N")  # beyond hi[0]
    assert BatchAligner._pack2(arr, lo, hi) is not None


def test_pack_rejects_embedded_nul():
    """A sequence byte of \\0 must force the RAW upload path in both the
    native and numpy packers (packing it as code 0 would decode as 'A'
    on device — a silent bit-exactness violation found in review)."""
    import numpy as np

    from wfa_tpu import native

    eng = BatchAligner(Penalties(), Options(True), None, k_win=128, s_cap=128)
    nul_pairs = [(b"AC\x00GT", b"ACGTT"), (b"ACGT", b"ACGT")]
    out = eng._pack_all(nul_pairs)
    assert out[7] is None and out[8] is None, "native path must refuse NULs"
    if native.lib is not None:
        lib, native.lib = native.lib, None
        try:
            out_np = eng._pack_all(nul_pairs)
        finally:
            native.lib = lib
        assert out_np[7] is None and out_np[8] is None
    # ...and the engine still aligns such pairs exactly via the raw path
    oracle = OracleAligner(Penalties(), Options(True), None)
    for (q, t), res in zip(nul_pairs, eng.align_batch(nul_pairs)):
        ref = oracle.align(q, t)
        assert res.score == ref.score and res.cigar(False) == ref.cigar(False)


def test_numpy_fast_pack_path_engages():
    """The numpy fast pack path (no per-cell bounds mask) must actually
    engage for ordinary padded DNA batches and match the masked path."""
    import numpy as np

    arr = np.zeros((2, 8), np.uint8)
    arr[0, :5] = np.frombuffer(b"ACGTT", np.uint8)
    arr[1, 2:5] = np.frombuffer(b"GGC", np.uint8)
    lo = np.array([0, 2], np.int32)
    hi = np.array([5, 5], np.int32)
    from wfa_tpu.engine import _ACGT_LUT0

    codes = _ACGT_LUT0[arr]
    assert int(np.count_nonzero(arr)) == int(np.clip(hi - lo, 0, None).sum())
    assert int(codes.max()) <= 3  # the fast-path guard holds
    pk = BatchAligner._pack2(arr, lo, hi)
    assert pk is not None and pk.shape == (2, 2)


def test_numpy_pack_per_row_nul_check():
    """The fast-path validation must be PER ROW: a batch-global nonzero
    count can balance an in-bounds NUL in one row against out-of-bounds
    junk in another and silently pack the NUL as 'A' (review repro)."""
    import numpy as np

    arr = np.zeros((2, 8), np.uint8)
    arr[0, :5] = np.frombuffer(b"AC\x00GT", np.uint8)  # in-bounds NUL
    arr[1, :3] = np.frombuffer(b"GGC", np.uint8)
    arr[1, 6] = ord("G")  # out-of-bounds junk balances the global count
    lo = np.zeros(2, np.int32)
    hi = np.array([5, 3], np.int32)
    assert BatchAligner._pack2(arr, lo, hi) is None


def test_stop_tables_chunked_matches_single_pass(monkeypatch):
    """The big-K chunked c-space stop-table builder must be bit-equal to
    the single-pass build (the chunked branch only triggers past a 2 GB
    intermediate in production, so force it here)."""
    import numpy as np

    import jax.numpy as jnp
    from wfa_tpu import engine as eng_mod
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu.engine import BatchAligner, _stop_tables
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties

    pairs = generate_pairs(3, 150, 0.1, seed=13)
    packer = BatchAligner(Penalties(), Options(True),
                          AdaptiveReductionOption(), k_win=384, s_cap=64)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packer.pack_batch(pairs)
    args = (jnp.asarray(qb), jnp.asarray(tbuf), jnp.asarray(qlen),
            jnp.asarray(tlen), jnp.asarray(toff))
    w1, f1 = _stop_tables(*args, 384, Lq, Ltb)
    monkeypatch.setattr(eng_mod, "_STOP_TABLES_CHUNK_BYTES", 0)
    w2, f2 = _stop_tables(*args, 384, Lq, Ltb)
    assert np.array_equal(np.asarray(w1), np.asarray(w2))
    assert np.array_equal(np.asarray(f1), np.asarray(f2))
