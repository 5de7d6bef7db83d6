"""CLI tests: flag parity and byte-exact output vs reference-recorded blocks."""

import io
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = os.path.join(REPO, "tests", "data", "seqs.txt")

# README.md:245-254 of the reference — recorded `wfa-go -i seqs.txt` output
# for pair 1 (current-format v0.4.0 output).
PAIR1_BLOCK = """\
query   A-TTGGAAAATAGGATTGGGGTTTGTTTATATTTGGGTTGAGGGATGTCCCACCTTCGTCGTCCTTACGTTTCCGGAAGGGAGTGGTTAGCTCGAAGCCCA
          |||||||||||||| ||||||||||||||||||||||||||||||||||||||| ||||||||||||||||||||||||||||||| ||||||||||||
target  GATTGGAAAATAGGAT-GGGGTTTGTTTATATTTGGGTTGAGGGATGTCCCACCTT-GTCGTCCTTACGTTTCCGGAAGGGAGTGGTT-GCTCGAAGCCCA
cigar   1X1I14M1D39M1D31M1D12M

align-score : 36
match-region: q[2, 100]/100 vs t[3, 98]/98
align-length: 99, matches: 96 (96.97%), gaps: 3, gap regions: 3
"""

# README.md:230-239 — recorded positional-args output.
POSITIONAL_BLOCK = """\
query   AGCTA-GTGTCAATGGCTACT---TTTCAGGTCCT
        | ||| |||||  ||||||||   | |||||||||
target  AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT
cigar   1M1X3M1I5M2X8M3I1M1X9M

align-score : 36
match-region: q[1, 31]/31 vs t[1, 35]/35
align-length: 35, matches: 27 (77.14%), gaps: 4, gap regions: 2
"""


def run_cli(*args):
    from wfa_tpu import cli

    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = cli.main(list(args))
    finally:
        sys.stdout = old
    return rc, buf.getvalue()


def test_cli_file_mode_pair1():
    rc, out = run_cli("-i", SEQS)
    assert rc == 0
    blocks = out.strip("\n").split("\n\n")
    # output format: [rows+cigar, stats] per pair
    got_pair1 = "\n\n".join([blocks[0], blocks[1]]) + "\n"
    assert got_pair1 == PAIR1_BLOCK


def test_cli_positional_mode():
    rc, out = run_cli(
        "AGCTAGTGTCAATGGCTACTTTTCAGGTCCT",
        "AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT",
    )
    assert rc == 0
    assert out == POSITIONAL_BLOCK + "\n"


def test_cli_no_output_flag():
    rc, out = run_cli("-i", SEQS, "-N")
    assert rc == 0
    assert out == ""


def test_cli_bad_pair_does_not_poison_run(tmp_path, capsys):
    """An empty line in a pair file must produce a per-pair error report
    while every other pair still aligns (SURVEY §5; the reference guards
    per call, wfa.go:187-193)."""
    f = tmp_path / "pairs.txt"
    f.write_bytes(b">ACCATACTCG\n<AGGATGCTCG\n>\n<ACGT\n>ACGT\n<ACGT\n")
    rc, out = run_cli("-i", str(f))
    assert rc == 0
    err = capsys.readouterr().err
    assert "pair 2" in err and "empty sequence" in err
    blocks = out.strip("\n").split("\n\n")
    assert len(blocks) == 4  # two good pairs, two blocks each
    assert "align-score : 12" in out  # pair 1
    assert "align-score : 0" in out  # pair 3 (perfect match)


def test_pipeline_bad_pairs_masked():
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu.constants import MAX_SEQ_LEN, EmptySeqError, SeqTooLongError
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    class FakeLong(bytes):  # too-long guard without allocating 512MB
        def __len__(self):
            return MAX_SEQ_LEN + 1

    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1)))
    pairs = [(b"ACGT", b"ACGT"), (b"", b"ACGT"), (FakeLong(b"A"), b"ACGT"),
             (b"ACCATACTCG", b"AGGATGCTCG")]
    rs = pipe.align_all(pairs)
    assert rs[0].error is None and rs[0].score == 0
    assert isinstance(rs[1].error, EmptySeqError)
    assert isinstance(rs[2].error, SeqTooLongError)
    assert rs[3].error is None and rs[3].score == 12
    # host-only path applies the same guards
    pipe2 = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), use_device=False))
    rs2 = pipe2.align_all(pairs[:2])
    assert rs2[0].score == 0 and isinstance(rs2[1].error, EmptySeqError)


def test_cli_missing_args_errors():
    rc, _ = run_cli("ONLYONESEQ")
    assert rc == 1


def test_cli_trim_flag():
    """-t trims to the first..last M run (reference trimOps,
    wfa_cigar.go:217-233); verified trimmed cigar for the front example."""
    rc, out = run_cli(
        "-g", "-t", "Bioinformatics helps Biology",
        "We learn bioinformatics to help biologists",
    )
    assert rc == 0
    assert "cigar   14M3I4M1D1M1X5M" in out
    assert "query   ioinformatics ---helps Biolog" in out


def test_cli_trim_no_match_region(tmp_path, capsys):
    """-t on a pair whose alignment has no M op: the reference CLI
    PANICS (trimOps slices ops[-1:0], wfa_cigar.go:217-233) — here the
    pair is reported on stderr and the run continues (SURVEY §5
    per-pair failure masking), found by tests/fuzz.py stage 5."""
    from wfa_tpu import cli

    infile = tmp_path / "pairs.txt"
    infile.write_text(">A\n<G\n>ACCATACTCG\n<AGGATGCTCG\n")
    rc = cli.main(["-i", str(infile), "-t", "--no-device"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "pair 1: no aligned (M) region to trim to" in captured.err
    # the second pair still rendered
    assert "cigar   1M2X2M1X4M" in captured.out


def test_cli_semi_global_flag():
    # README.md:17-27 front-page example (semi-global)
    rc, out = run_cli(
        "-g", "Bioinformatics helps Biology",
        "We learn bioinformatics to help biologists",
    )
    assert rc == 0
    assert "align-score : 32" in out
    assert "cigar   9I1X14M3I4M1D1M1X5M1X3I" in out
    assert "match-region: q[2, 27]/28 vs t[11, 38]/42" in out
    assert "align-length: 29, matches: 24 (82.76%), gaps: 4, gap regions: 2" in out


def test_cli_resume(tmp_path, capsys):
    """--resume skips pairs recorded as completed and appends progress."""
    import wfa_tpu.cli as cli
    from wfa_tpu.datagen import generate_pairs, write_pair_file

    pairs = generate_pairs(6, 40, 0.1, seed=11)
    infile = tmp_path / "pairs.txt"
    write_pair_file(str(infile), pairs)
    state = tmp_path / "progress"

    assert cli.main(["-i", str(infile), "-N", "--no-device",
                     "--resume", str(state)]) == 0
    assert state.read_text() == "6"

    # pre-seed partial progress: only the remaining pairs are aligned
    state.write_text("4")
    assert cli.main(["-i", str(infile), "--no-device",
                     "--resume", str(state)]) == 0
    assert state.read_text() == "6"
    blocks = capsys.readouterr().out.count("align-score")
    assert blocks == 2


def test_pipeline_survives_device_faults(monkeypatch):
    """A device-side fault (e.g. a device runtime error) must not lose
    the run: failed chunks re-queue, and after repeated faults the remaining
    work completes exactly on the host oracle (SURVEY §5 failure
    detection/recovery)."""
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu.engine import BatchAligner
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1),
        batch_size=4, n_devices=1))
    calls = {"n": 0}
    orig = BatchAligner.submit_batch

    def dying_submit(self, pairs, *a, **k):
        calls["n"] += 1
        raise RuntimeError("device runtime error")

    monkeypatch.setattr(BatchAligner, "submit_batch", dying_submit)
    pairs = [(b"ACCATACTCG", b"AGGATGCTCG"),
             (b"ACGT", b"ACGT"), (b"AACGT", b"ACGTT")]
    results = pipe.align_all(pairs)
    assert calls["n"] >= 2  # it retried before giving up on the device
    assert results[0].score == 12 and results[0].cigar(False) == "1M2X2M1X4M"
    assert results[1].score == 0
    monkeypatch.setattr(BatchAligner, "submit_batch", orig)
    # the fault budget is per call: the SAME pipeline recovers once the
    # device is healthy again (a transient device error must not disable
    # the device path for the rest of a long run)
    pipe._engines.clear()
    calls["n"] = 0
    results2 = pipe.align_all(pairs)
    assert calls["n"] == 0 and results2[0].score == 12
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0
