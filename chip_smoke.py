"""Smoke check of the aligner's main path on one GPU.

Drives the system through the entry points a user calls
(``AlignmentPipeline.align_all`` and the CLI) in one process, and checks
every compared pair bit for bit against the host oracle
(``OracleAligner``): score, CIGAR, coordinates and stats.  The work is
integer only, so the tolerance is zero.

Phases, one line each with sizes, wall time and aln/s:

  1  device: JAX's devices and nvidia-smi's name and power limit
  2  global l=1000 e=0.05, 16,384 pairs in batches of 2,048 (the
     headline workload), 1,024 pairs spread over every batch compared
  3  semi-global l=1000 e=0.05, 2,048 pairs, 256 compared
  4  long global reads l=10,000 e=0.05, 64 pairs, all compared
  5  the CLI on tests/data/seqs.txt, byte-equal to its --no-device run

``--devices 4`` runs phase 2's workload data-parallel over four cards
(the shard_map path) instead, and nothing else: results must equal a
one-card run of the same pairs, and the sample must match the oracle.

Any device fault, any pair finished on the host oracle instead of the
device, or any mismatch fails the run.  The last line printed is
``{"ok": true, "device": {"platform", "kind", "count"}}``; a failed run
exits non-zero without it.  No GPU, no run.

Usage: python chip_smoke.py [--devices 4] [--trace DIR]
(``--trace DIR`` records a jax.profiler trace of phase 2's timed call.)
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import redirect_stdout
from multiprocessing import get_context

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 42
PEN = (4, 6, 2)
ADAPTIVE = (10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")


def _digest(res):
    return tuple(getattr(res, f) for f in FIELDS) + (res.cigar(False),)


def _peak_mem() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 1e9:.2f}GB"


def _oracle_digests(args):
    """Worker: oracle digests of a list of pairs (host only, no JAX)."""
    global_alignment, pairs = args
    from wfa_tpu import (AdaptiveReductionOption, Options, OracleAligner,
                         Penalties)

    oracle = OracleAligner(Penalties(*PEN), Options(global_alignment),
                           AdaptiveReductionOption(*ADAPTIVE))
    return [_digest(oracle.align(q, t)) for q, t in pairs]


class Smoke:
    def __init__(self, workers: int):
        self.workers = workers
        self.pool = ProcessPoolExecutor(
            max_workers=workers, mp_context=get_context("spawn"))

    def close(self):
        self.pool.shutdown(cancel_futures=True)

    def oracle(self, global_alignment, pairs):
        step = max(1, -(-len(pairs) // (4 * self.workers)))
        parts = [(global_alignment, pairs[i:i + step])
                 for i in range(0, len(pairs), step)]
        return [d for part in self.pool.map(_oracle_digests, parts)
                for d in part]

    @staticmethod
    def pipeline(global_alignment, batch_size, n_devices=1):
        from wfa_tpu import AdaptiveReductionOption, Options, Penalties
        from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

        return AlignmentPipeline(PipelineConfig(
            Penalties(*PEN), Options(global_alignment),
            AdaptiveReductionOption(*ADAPTIVE), batch_size=batch_size,
            n_devices=n_devices))

    @staticmethod
    def run(pipe, pairs):
        """One align_all; fails on a device fault or an oracle-finished
        pair.  Returns (results, wall seconds)."""
        t0 = time.perf_counter()
        results = pipe.align_all(pairs)
        wall = time.perf_counter() - t0
        if pipe.device_faults or pipe.oracle_pairs:
            raise RuntimeError(
                f"{pipe.device_faults} device faults, {pipe.oracle_pairs} "
                "pairs finished on the host oracle")
        return results, wall

    def check(self, global_alignment, pairs, results, idx):
        want = self.oracle(global_alignment, [pairs[i] for i in idx])
        bad = [i for i, w in zip(idx, want) if _digest(results[i]) != w]
        if bad:
            raise RuntimeError(f"{len(bad)}/{len(idx)} pairs differ from "
                               f"the oracle, first at index {bad[0]}")

    def workload(self, name, global_alignment, n, length, batch, n_cmp,
                 warm, trace=None):
        from wfa_tpu.datagen import generate_pairs

        pairs = generate_pairs(n, length, 0.05, seed=SEED)
        pipe = self.pipeline(global_alignment, batch)
        # the score-cap refit after a call recompiles, so the timed call
        # comes after two warm ones
        for _ in range(warm):
            self.run(pipe, pairs)
        if trace:
            import jax

            jax.profiler.start_trace(trace)
        try:
            results, wall = self.run(pipe, pairs)
        finally:
            if trace:
                jax.profiler.stop_trace()
        idx = list(range(0, n, max(1, n // n_cmp)))[:n_cmp]
        self.check(global_alignment, pairs, results, idx)
        print(f"phase {name}: n={n} l={length} e=0.05 batch={batch} "
              f"wall={wall:.3f}s aln/s={n / wall:.1f} compared={len(idx)} "
              f"bit-exact faults=0 oracle_pairs=0 peak_mem={_peak_mem()}",
              flush=True)
        if trace:
            # one lockstep score-loop iteration per score up to each
            # batch's highest final score
            tops = [max(r.score for r in results[i:i + batch])
                    for i in range(0, n, batch)]
            print(f"trace {trace}: batches of {batch}, max final score "
                  f"per batch {tops}", flush=True)
        return pairs, results

    def cli(self):
        from wfa_tpu import cli
        from wfa_tpu.pipeline import AlignmentPipeline

        seqs = os.path.join(REPO, "tests", "data", "seqs.txt")
        calls = []
        align_all = AlignmentPipeline.align_all

        def counted(pipe, pairs):
            out = align_all(pipe, pairs)
            calls.append((pipe.device_faults, pipe.oracle_pairs))
            return out

        AlignmentPipeline.align_all = counted
        try:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                rc = cli.main(["-i", seqs])
            wall = time.perf_counter() - t0
        finally:
            AlignmentPipeline.align_all = align_all
        ref = io.StringIO()
        with redirect_stdout(ref):
            rc_ref = cli.main(["-i", seqs, "--no-device"])
        out = buf.getvalue()
        n = out.count("align-score")
        first = out.split("\n\n")[:2]
        if rc or rc_ref or not calls or any(f or o for f, o in calls):
            raise RuntimeError(f"cli rc={rc}/{rc_ref}, counters {calls}")
        if (out != ref.getvalue() or "align-score : 36" not in first[1]
                or "cigar   1X1I14M1D39M1D31M1D12M" not in first[0]):
            raise RuntimeError("cli output differs from the oracle run")
        print(f"phase 5 cli: n={n} wall={wall:.3f}s aln/s={n / wall:.1f} "
              f"first block score 36 cigar 1X1I14M1D39M1D31M1D12M, "
              f"output byte-equal to --no-device", flush=True)

    def multi(self, n_devices, n=16384, length=1000, batch=2048,
              n_cmp=1024):
        from wfa_tpu.datagen import generate_pairs

        pairs = generate_pairs(n, length, 0.05, seed=SEED)
        single = self.pipeline(True, batch, 1)
        ref = [_digest(r) for r in self.run(single, pairs)[0]]
        pipe = self.pipeline(True, batch, n_devices)
        for _ in range(2):
            self.run(pipe, pairs)
        results, wall = self.run(pipe, pairs)
        if [_digest(r) for r in results] != ref:
            raise RuntimeError(f"{n_devices}-card results differ from one card")
        idx = list(range(0, n, max(1, n // n_cmp)))[:n_cmp]
        self.check(True, pairs, results, idx)
        print(f"phase 6 data-parallel: devices={n_devices} n={n} "
              f"l={length} e=0.05 batch={batch} wall={wall:.3f}s "
              f"aln/s={n / wall:.1f} identical to one card, "
              f"compared={len(idx)} bit-exact faults=0 oracle_pairs=0",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from bench import card_line, require_gpu

    devs = require_gpu()
    if len(devs) < args.devices:
        raise SystemExit(f"--devices {args.devices}: JAX sees {len(devs)}")
    from wfa_tpu import enable_compile_cache

    print(f"phase 1 device: {len(devs)} x {devs[0].device_kind} "
          f"({devs[0].platform}); compile cache {enable_compile_cache()}",
          flush=True)
    print(card_line(), flush=True)
    smoke = Smoke(workers=max(1, min(16, (os.cpu_count() or 2) - 2)))
    try:
        if args.devices > 1:
            smoke.multi(args.devices)
        else:
            smoke.workload("2 global", True, 16384, 1000, 2048, 1024, 2,
                           trace=args.trace)
            smoke.workload("3 semi-global", False, 2048, 1000, 2048, 256, 2)
            smoke.workload("4 long global", True, 64, 10000, 2048, 64, 2)
            smoke.cli()
    finally:
        smoke.close()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
