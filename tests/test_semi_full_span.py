"""Semi-global alignment through the pipeline's full-span route.

Semi-global seeds every diagonal (wfa.go:163-183), so every tier runs
the XLA engine with the window holding the full diagonal span; the
tiers raise the score cap and widen the stop-table read window.  Each
case checks score, CIGAR, coordinates and stats against the oracle,
that no pair finished on the host oracle, and that the window really
spans every diagonal — across lengths (full spans past 512 included),
error rates, penalty sets and adaptive on and off.
"""

import pytest

from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.oracle import Aligner as OracleAligner
from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

SEMI = Options(global_alignment=False)
ADA = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")


def _assert_oracle(pipe, pairs, results):
    oracle = OracleAligner(pipe.cfg.penalties, SEMI, pipe.cfg.adaptive)
    for (q, t), r in zip(pairs, results):
        o = oracle.align(q, t)
        assert r.cigar(False) == o.cigar(False), (q, t)
        for f in FIELDS:
            assert getattr(r, f) == getattr(o, f), (f, q, t)
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0
    longest = max(len(q) + len(t) for q, t in pairs)
    assert pipe._engines and all(k_win >= longest
                                 for k_win, _, _ in pipe._engines)


@pytest.mark.parametrize("pen,adaptive,l,e,n", [
    (Penalties(4, 6, 2), ADA, 60, 0.05, 6),
    (Penalties(4, 6, 2), ADA, 200, 0.05, 6),
    (Penalties(4, 6, 2), ADA, 200, 0.20, 4),
    (Penalties(4, 6, 2), ADA, 300, 0.08, 4),   # full span 640 > 512
    (Penalties(4, 6, 2), ADA, 600, 0.05, 3),   # windowed table reads
    (Penalties(4, 6, 2), None, 150, 0.10, 4),
    (Penalties(4, 6, 2), None, 300, 0.05, 3),  # full span 640 > 512
    (Penalties(1, 2, 2), ADA, 150, 0.10, 4),
    (Penalties(2, 3, 1), ADA, 150, 0.10, 4),
    (Penalties(1, 2, 2), None, 100, 0.15, 4),
    (Penalties(2, 3, 1), None, 100, 0.15, 4),
    (Penalties(2, 0, 2), ADA, 150, 0.10, 4),   # open == 0
    (Penalties(3, 5, 2), ADA, 120, 0.10, 4),
    (Penalties(6, 2, 3), ADA, 120, 0.10, 4),
], ids=lambda v: (f"{v.mismatch}-{v.gap_open}-{v.gap_ext}"
                  if isinstance(v, Penalties) else
                  "adaptive" if isinstance(v, AdaptiveReductionOption)
                  else "plain" if v is None else str(v)))
def test_semi_pipeline_full_span_matches_oracle(pen, adaptive, l, e, n):
    pipe = AlignmentPipeline(PipelineConfig(
        penalties=pen, options=SEMI, adaptive=adaptive, batch_size=4,
        n_devices=1))
    pairs = generate_pairs(n, l, e, seed=l + n)
    _assert_oracle(pipe, pairs, pipe.align_all(pairs))


@pytest.mark.parametrize("adaptive", [ADA, None], ids=["adaptive", "plain"])
def test_semi_pipeline_ragged_mesh(adaptive):
    """A ragged batch over the 8-device CPU mesh: 11 pairs pad to 16,
    each device runs the full-span window on its shard."""
    pipe = AlignmentPipeline(PipelineConfig(
        penalties=Penalties(4, 6, 2), options=SEMI, adaptive=adaptive,
        batch_size=11, n_devices=8))
    assert pipe._mesh is not None and pipe._mesh.devices.size == 8
    pairs = generate_pairs(11, 280, 0.06, seed=77)
    _assert_oracle(pipe, pairs, pipe.align_all(pairs))
