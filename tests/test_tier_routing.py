"""Pipeline tier caps: every class runs the XLA engine, and the caps
pick its diagonal window, score cap, stop-table read window and batch
admission.  Global reads past l=4096 keep the narrow tier-0 window and
read the stop tables through a windowed slice; semi-global holds the
full diagonal span at every tier.  Routing decisions only — the
bit-exactness of these routes lives in tests/test_long_pairs.py,
tests/test_semi_full_span.py and tests/test_gpu_bringup.py."""

import dataclasses

from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

PEN = Penalties(4, 6, 2)
ADA = AdaptiveReductionOption(10, 50, 1)
GIB = 1 << 30


def _cfg(**kw):
    kw.setdefault("hbm_budget", 30 * GIB)
    return PipelineConfig(penalties=PEN, options=Options(True),
                          adaptive=ADA, n_devices=1, **kw)


def test_long_reads_route_to_longread_kernel():
    """l=50k global: the narrow tier-0 window with windowed stop-table
    reads on the XLA engine, admitted within the budget."""
    pipe = AlignmentPipeline(_cfg())
    caps = pipe._tier_caps(50000, 50000, 0)
    assert caps.k_win == 384 and caps.w_win == 128
    # tier 0's score cap must cover e=0.1 workloads (score ~0.53*l) so
    # they don't burn a doomed full-length pass before tier 1
    assert caps.s_cap >= int(0.54 * 50000)
    assert 1 <= caps.b_cap and caps.batch_bytes <= pipe.hbm_budget
    # retries widen the read window, not the diagonal window
    assert [pipe._tier_caps(50000, 50000, t).w_win
            for t in (1, 2)] == [256, 512]
    assert pipe._tier_caps(50000, 50000, 2).k_win == 384


def test_midlength_routes_to_longread_kernel():
    pipe = AlignmentPipeline(_cfg())
    for l in (10000, 20000):
        caps = pipe._tier_caps(l, l, 0)
        assert caps.k_win <= 512 and caps.w_win == 128, (l, caps)


def test_just_past_int16_band_keeps_main_kernel():
    """l past the 13-bit offset limit but at most 4096: whole-table
    reads, the tight window, over a thousand pairs admitted."""
    pipe = AlignmentPipeline(_cfg(batch_size=2048))
    caps = pipe._tier_caps(4000, 4000, 0)
    assert caps.w_win is None and caps.k_win == 256
    assert caps.b_cap >= 1024


def test_short_reads_route_plain():
    pipe = AlignmentPipeline(_cfg())
    caps = pipe._tier_caps(1000, 1000, 0)
    assert (caps.k_win, caps.s_cap, caps.w_win) == (128, 640, None)
    # the ladder widens the window, then spans every diagonal
    assert pipe._tier_caps(1000, 1000, 1).k_win == 512
    assert pipe._tier_caps(1000, 1000, 2).k_win == 2048


def test_tiny_budget_falls_to_longread_kernel():
    """A budget below one l=50k pair's history clamps the score cap so
    that one pair fits, rather than admitting a batch that cannot."""
    pipe = AlignmentPipeline(_cfg(hbm_budget=200 << 20))
    caps = pipe._tier_caps(50000, 50000, 0)
    assert caps.b_cap >= 1
    assert caps.batch_bytes <= 200 << 20
    assert caps.s_cap < int(0.55 * 50000)


def test_semi_global_unaffected():
    cfg = dataclasses.replace(_cfg(), options=Options(False))
    pipe = AlignmentPipeline(cfg)
    for tier in (0, 1, 2, 3):
        caps = pipe._tier_caps(1000, 1010, tier)
        assert caps.k_win == 2048, (tier, caps)  # the full diagonal span
    assert [pipe._tier_caps(1000, 1010, t).w_win for t in (0, 1, 2)] == [
        32, 64, None]


def test_score_cap_memory_feedback():
    """High-error workloads must not burn a doomed tier-0 pass forever:
    align_all records each bucket's observed max final score, and the
    next call's tier-0 cap is fitted to it (VERDICT r4 #4).  The same
    memory shrinks caps again when the workload gets easier."""
    from wfa_tpu.datagen import generate_pairs

    pipe = AlignmentPipeline(_cfg(batch_size=32))
    base = pipe._tier_caps(1000, 1000, 0)[1]  # un-fitted: 0.55*l
    pairs = generate_pairs(8, 1000, 0.2, seed=3)
    res = pipe.align_all(pairs)
    assert all(r is not None for r in res)
    mx = max(r.score for r in res)
    assert mx > base, "e=0.2 scores must exceed the default tier-0 cap"
    fitted = pipe._tier_caps(1000, 1000, 0, skey=(1024, 1024))[1]
    assert fitted >= mx, (fitted, mx)
    # second call runs tier 0 straight at the fitted cap: same results
    res2 = pipe.align_all(pairs)
    assert [r.score for r in res2] == [r.score for r in res]
    # easier workload shrinks the memory again
    easy = generate_pairs(8, 1000, 0.02, seed=4)
    pipe.align_all(easy)
    shrunk = pipe._tier_caps(1000, 1000, 0, skey=(1024, 1024))[1]
    assert shrunk < fitted
