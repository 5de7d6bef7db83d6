"""Realistic-length (l~1000) bit-exactness tests for the device engine.

Every other correctness test uses max_len <= 120; the benchmarked paths
(w_win streaming windows, tier ladders, 16-bit tokens) only engage at
realistic lengths, so a handful of l~1000 pairs are checked end-to-end
against the oracle here, adaptive on and off.
"""

import pytest

from wfa_tpu import AdaptiveReductionOption, Options, Penalties, OracleAligner
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner


def _check(engine, oracle, pairs, ctx):
    for (q, t), res in zip(pairs, engine.align_batch(pairs)):
        ref = oracle.align(q, t)
        assert res.score == ref.score, (ctx, q[:40], t[:40])
        assert res.cigar(False) == ref.cigar(False), (ctx, q[:40])
        for attr in ("q_begin", "q_end", "t_begin", "t_end", "align_len",
                     "matches", "gaps", "gap_regions"):
            assert getattr(res, attr) == getattr(ref, attr), (ctx, attr)


@pytest.mark.parametrize("adaptive", [None, AdaptiveReductionOption(10, 50, 1)],
                         ids=["plain", "adaptive"])
def test_l1000_bit_exact(adaptive):
    p = Penalties(4, 6, 2)
    oracle = OracleAligner(p, Options(True), adaptive)
    # e=0.05 at l=1000: scores ~300; k_win 192 covers the plain (untrimmed)
    # band
    eng = BatchAligner(p, Options(True), adaptive, k_win=192, s_cap=640)
    pairs = generate_pairs(3, 1000, 0.05, seed=17)
    _check(eng, oracle, pairs, "l1000")


def test_l1000_jax_streaming_window():
    """The windowed stop-table read path (w_win) at realistic length."""
    p = Penalties(4, 6, 2)
    ad = AdaptiveReductionOption(10, 50, 1)
    oracle = OracleAligner(p, Options(True), ad)
    eng = BatchAligner(p, Options(True), ad, k_win=128, s_cap=640,
                      w_win=16)
    pairs = generate_pairs(2, 1000, 0.05, seed=23)
    _check(eng, oracle, pairs, "jax-w16-l1000")


def test_l1000_semi_global_jax():
    """Semi-global at l=1000 (full-span window)."""
    p = Penalties(4, 6, 2)
    ad = AdaptiveReductionOption(10, 50, 1)
    oracle = OracleAligner(p, Options(False), ad)
    eng = BatchAligner(p, Options(False), ad, k_win=2176, s_cap=640,
                      w_win=16)
    pairs = generate_pairs(2, 1000, 0.05, seed=29)
    _check(eng, oracle, pairs, "semi-l1000")


def test_pipeline_indel_heavy_distribution_shift():
    """Indel-heavy reads (long drifting diagonals) stress the tier
    ladder's window heuristics; results must stay exact regardless of
    which tier (or the oracle fallback) serves each pair."""
    import random

    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    rng = random.Random(4242)
    BASES = "ACGT"
    pairs = []
    for _ in range(12):
        n = rng.randint(400, 900)
        q = [rng.choice(BASES) for _ in range(n)]
        t = list(q)
        # a few large indels (30-120bp) plus scattered noise
        for _ in range(rng.randint(1, 4)):
            pos = rng.randrange(max(1, len(t) - 1))
            chunk = [rng.choice(BASES) for _ in range(rng.randint(30, 120))]
            if rng.random() < 0.5:
                t[pos:pos] = chunk
            else:
                del t[pos:pos + len(chunk)]
        pairs.append(("".join(q).encode(), ("".join(t) or "A").encode()))
    p = Penalties(4, 6, 2)
    ad = AdaptiveReductionOption(10, 50, 1)
    oracle = OracleAligner(p, Options(True), ad)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ad,
                                            batch_size=12, n_devices=1))
    for (q, t), res in zip(pairs, pipe.align_all(pairs)):
        ref = oracle.align(q, t)
        assert res.score == ref.score, (q[:30], t[:30])
        assert res.cigar(False) == ref.cigar(False)


def test_pipeline_long_sequence_tiers():
    """l>4096 pairs through the production pipeline: exercises the
    long-sequence cap ladder (w_win streaming, 32-bit tokens)
    end-to-end, bit-exact vs the oracle."""
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    p = Penalties(4, 6, 2)
    ad = AdaptiveReductionOption(10, 50, 1)
    oracle = OracleAligner(p, Options(True), ad)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ad,
                                            batch_size=4, n_devices=1))
    pairs = generate_pairs(2, 6000, 0.05, seed=41)
    for (q, t), res in zip(pairs, pipe.align_all(pairs)):
        ref = oracle.align(q, t)
        assert res.score == ref.score
        assert res.cigar(False) == ref.cigar(False)
        assert (res.align_len, res.matches, res.gaps, res.gap_regions) == (
            ref.align_len, ref.matches, ref.gaps, ref.gap_regions)
