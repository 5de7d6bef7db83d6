"""Randomized cross-engine fuzz: every engine vs the oracle (and the
oracle vs exact DP where WFA is provably optimal).

NOT collected by pytest (no test_ prefix) — it is the long-running
randomized companion to the fixed suite, run per round as a standalone
tool.  Stages (each time-bounded):

  1 jax engine, broad random penalties/shapes, global+semi, adaptive
    on/off; plus oracle-score vs exact-DP cross-checks
  2 semi-global pipeline on the full-span window (l>256 so
    full_span>512)
  3 data-parallel pipeline over a virtual device mesh (ragged batches,
    shard padding, per-shard token plans)
  4 global pipeline tier ladder at mid lengths (l 300-1500, escapes)
  5 CLI round-trip: full stdout byte-equality between --no-device
    (oracle) and the device-engine path over random files and flags

Usage: PYTHONPATH=. python tests/fuzz.py <stage> [budget_s]
Env: WFA_FUZZ_SEED pins the RNG (default: wall clock).

NB long runs need ``vm.max_map_count`` raised (each compile adds
mappings; the 65530 default dies with LLVM "Cannot allocate memory").
"""
import os
import random
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from wfa_tpu import AdaptiveReductionOption, Options, Penalties, OracleAligner
from wfa_tpu.engine import BatchAligner

BASES = "ACGT"


def mutate(rng, q, rate):
    out = []
    for ch in q:
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
    return "".join(out) or "A"


def random_pairs(rng, count, max_len):
    pairs = []
    for _ in range(count):
        kind = rng.random()
        n = rng.randint(1, max_len)
        q = "".join(rng.choice(BASES) for _ in range(n))
        if kind < 0.1:  # unrelated
            t = "".join(rng.choice(BASES)
                        for _ in range(rng.randint(1, max_len)))
        elif kind < 0.2:  # identical
            t = q
        elif kind < 0.3:  # big length skew
            t = mutate(rng, q[: max(1, n // 3)], 0.1)
        elif kind < 0.35:  # binary bytes
            qb = bytes(rng.randrange(256) for _ in range(n))
            tb = bytes(rng.randrange(256) for _ in range(max(1, n - 2)))
            pairs.append((qb, tb))
            continue
        else:
            t = mutate(rng, q, rng.choice([0.02, 0.05, 0.15, 0.3, 0.5]))
        pairs.append((q.encode(), t.encode()))
    return pairs


def rand_pen(rng, gate=None):
    while True:
        p = Penalties(rng.randint(1, 8), rng.randint(0, 12),
                      rng.randint(1, 6))
        if gate is None or gate(p):
            return p


def rand_adaptive(rng):
    if rng.random() < 0.3:
        return None
    return AdaptiveReductionOption(rng.randint(1, 20), rng.randint(5, 80), 1)


def check(engine, oracle, pairs, tag):
    res = engine.align_batch(pairs)
    for (q, t), r in zip(pairs, res):
        ref = oracle.align(q, t)
        ok = (r.score == ref.score and r.cigar(False) == ref.cigar(False)
              and r.align_len == ref.align_len and r.matches == ref.matches
              and (r.q_begin, r.q_end, r.t_begin, r.t_end)
              == (ref.q_begin, ref.q_end, ref.t_begin, ref.t_end))
        if not ok:
            print(f"MISMATCH [{tag}] q={q!r} t={t!r}\n"
                  f"  got  score={r.score} cigar={r.cigar(False)}\n"
                  f"  want score={ref.score} cigar={ref.cigar(False)}",
                  flush=True)
            return False
    return True


def stage1(rng, deadline):
    from wfa_tpu.dp import dp_score

    rounds = fails = 0
    while time.time() < deadline:
        p = rand_pen(rng)
        glob = rng.random() < 0.6
        ad = rand_adaptive(rng)
        opts = Options(glob)
        oracle = OracleAligner(p, opts, ad)
        k_win = 256 if glob else 512
        eng = BatchAligner(p, opts, ad, k_win=k_win, s_cap=256)
        pairs = random_pairs(rng, 12, 90)
        if not check(eng, oracle, pairs, f"jax p={p} g={glob} ad={ad}"):
            fails += 1
        # oracle score vs exact DP ground truth (global, no adaptive:
        # plain WFA is provably optimal there)
        if glob and ad is None:
            for q, t in pairs[:4]:
                if max(len(q), len(t)) <= 60:
                    want = dp_score(q, t, p)
                    got = oracle.align(q, t).score
                    if got != want:
                        print(f"ORACLE-vs-DP MISMATCH p={p} q={q!r} t={t!r}"
                              f" got={got} want={want}", flush=True)
                        fails += 1
        rounds += 1
    return rounds, fails


def stage2(rng, deadline):
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    rounds = fails = 0
    while time.time() < deadline:
        p = Penalties(4, 6, 2) if rng.random() < 0.5 else rand_pen(rng)
        ad = AdaptiveReductionOption(10, rng.choice([20, 50]), 1)
        cfg = PipelineConfig(penalties=p,
                             options=Options(global_alignment=False),
                             adaptive=ad, batch_size=64)
        pipe = AlignmentPipeline(cfg)
        oracle = OracleAligner(p, Options(False), ad)
        n = rng.randint(280, 400)
        pairs = []
        for _ in range(6):
            q = "".join(rng.choice(BASES) for _ in range(n))
            pairs.append((q.encode(),
                          mutate(rng, q, rng.choice([0.05, 0.15])).encode()))
        res = pipe.align_all(pairs)
        for (q, t), r in zip(pairs, res):
            ref = oracle.align(q, t)
            if (r.score, r.cigar(False)) != (ref.score, ref.cigar(False)):
                print(f"SEMI MISMATCH p={p} ad={ad} n={n}\n  q={q!r}\n"
                      f"  t={t!r}\n  got {r.score} {r.cigar(False)}\n"
                      f"  want {ref.score} {ref.cigar(False)}", flush=True)
                fails += 1
        rounds += 1
    return rounds, fails


def stage3(rng, deadline):
    """Random workloads through the data-parallel mesh pipeline
    (8 virtual CPU devices set up below): ragged batches, shard
    padding, divergent per-shard token plans."""
    from wfa_tpu.parallel import make_dp_mesh
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    rounds = fails = 0
    while time.time() < deadline:
        p = Penalties(4, 6, 2) if rng.random() < 0.4 else rand_pen(rng)
        glob = rng.random() < 0.7
        ad = rand_adaptive(rng)
        nd = rng.choice([2, 4, 8])
        cfg = PipelineConfig(penalties=p, options=Options(glob),
                             adaptive=ad, batch_size=rng.choice([16, 64]),
                             n_devices=nd)
        pipe = AlignmentPipeline(cfg)
        oracle = OracleAligner(p, Options(glob), ad)
        n = rng.randint(3, 40)  # often not a multiple of the mesh size
        pairs = random_pairs(rng, n, 90)
        res = pipe.align_all(pairs)
        for (q, t), r in zip(pairs, res):
            ref = oracle.align(q, t)
            if (r.score, r.cigar(False)) != (ref.score, ref.cigar(False)):
                print(f"MESH MISMATCH nd={nd} p={p} ad={ad}\n  q={q!r}\n"
                      f"  t={t!r}\n  got {r.score} {r.cigar(False)}\n"
                      f"  want {ref.score} {ref.cigar(False)}", flush=True)
                fails += 1
        rounds += 1
    return rounds, fails


def stage4(rng, deadline):
    """Mid-length global pairs through the pipeline's tier ladder —
    tier-0 window/score-cap escapes retrying on wider tiers."""
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    rounds = fails = 0
    while time.time() < deadline:
        p = Penalties(4, 6, 2) if rng.random() < 0.5 else rand_pen(rng)
        ad = AdaptiveReductionOption(10, 50, 1)
        cfg = PipelineConfig(penalties=p, options=Options(True),
                             adaptive=ad, batch_size=32)
        pipe = AlignmentPipeline(cfg)
        oracle = OracleAligner(p, Options(True), ad)
        n = rng.randint(300, 1500)
        pairs = []
        for _ in range(4):
            q = "".join(rng.choice(BASES) for _ in range(n))
            pairs.append((q.encode(),
                          mutate(rng, q,
                                 rng.choice([0.02, 0.1, 0.3])).encode()))
        res = pipe.align_all(pairs)
        for (q, t), r in zip(pairs, res):
            ref = oracle.align(q, t)
            if (r.score, r.cigar(False)) != (ref.score, ref.cigar(False)):
                print(f"TIER MISMATCH p={p} n={n}\n  q={q!r}\n  t={t!r}\n"
                      f"  got {r.score} {r.cigar(False)}\n"
                      f"  want {ref.score} {ref.cigar(False)}", flush=True)
                fails += 1
        rounds += 1
    return rounds, fails


def stage5(rng, deadline):
    """Random pair files + flag combinations through the CLI: the
    device-engine run's stdout must equal the oracle run's
    byte-for-byte (scores, cigars, 3-row text, stats, summary)."""
    import contextlib
    import io as io_mod
    import tempfile

    from wfa_tpu import cli

    def run(argv):
        buf = io_mod.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        assert rc == 0, (rc, argv)
        return buf.getvalue()

    rounds = fails = 0
    while time.time() < deadline:
        pairs = random_pairs(rng, rng.randint(1, 10), 80)
        # the file format strips the line's first char and newlines; keep
        # fuzz bytes printable so the file survives the round trip
        pairs = [
            (bytes(b % 94 + 33 for b in q), bytes(b % 94 + 33 for b in t))
            for q, t in pairs
        ]
        flags = []
        if rng.random() < 0.4:
            flags.append("-g")
        if rng.random() < 0.3:
            flags.append("-a")
        if rng.random() < 0.3:
            flags.append("-t")
        with tempfile.NamedTemporaryFile("wb", suffix=".txt",
                                         delete=False) as fh:
            for q, t in pairs:
                fh.write(b">" + q + b"\n<" + t + b"\n")
            path = fh.name
        base = ["-i", path, "--batch-size", str(rng.choice([4, 64]))]
        out_dev = run(base + flags)
        out_orc = run(base + flags + ["--no-device"])

        def strip_summary(s):  # the aln/s rate line differs per run
            return [ln for ln in s.splitlines()
                    if not ln.startswith("aligned ")]

        if strip_summary(out_dev) != strip_summary(out_orc):
            print(f"CLI MISMATCH flags={flags} file={path}", flush=True)
            for a, b in zip(strip_summary(out_dev), strip_summary(out_orc)):
                if a != b:
                    print(f"  dev: {a!r}\n  orc: {b!r}", flush=True)
                    break
            fails += 1
        else:
            os.unlink(path)
        rounds += 1
    return rounds, fails


def main():
    stage = int(sys.argv[1])
    budget = float(sys.argv[2]) if len(sys.argv) > 2 else 600
    seed = int(os.environ.get("WFA_FUZZ_SEED", "0")) or int(time.time())
    rng = random.Random(seed)
    print(f"stage {stage} seed {seed} budget {budget}s", flush=True)
    deadline = time.time() + budget
    rounds, fails = [None, stage1, stage2, stage3, stage4,
                     stage5][stage](rng, deadline)
    print(f"stage {stage}: {rounds} rounds, {fails} failures", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
