"""Headline benchmark: alignments/sec/chip on 1kb pairs (global, gap-affine).

Mirrors the reference's benchmark protocol (its README.md:296-323):
`generate_dataset -n N -l 1000 -e 0.05`, global alignment, wf-adaptive
10,50,1, full alignment computed (score + CIGAR/backtrace, like the
reference's `-N` mode which skips only the printing).

Baseline: the reference Go binary does n=100000 l=1000 e=0.05 in 15.424 s
on one laptop core = 6483 aln/s (reference benchmark.tsv:4).

Prints the card's name and power limit (as nvidia-smi reports them) on
one line, then ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Refuses to run without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

N_PAIRS = int(os.environ.get("WFA_BENCH_PAIRS", "32768"))
LENGTH = int(os.environ.get("WFA_BENCH_LEN", "1000"))
ERROR_RATE = float(os.environ.get("WFA_BENCH_ERR", "0.05"))
BASELINE_ALN_S = 6483.0  # wfa-go, l=1000 e=0.05 (benchmark.tsv:4)


def require_gpu():
    """jax.devices() when they are GPUs; exits non-zero otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found only {devs[0].platform} devices")
    return devs


def card_line() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _device_only(pipe, pairs, k_runs=8):
    """Device-only aln/s on the headline shape: one resident upload, K
    back-to-back dispatches of the compiled program, one tiny fetch of
    the last output — free of upload/download bandwidth effects."""
    import numpy as np

    import jax.numpy as jnp
    from wfa_tpu.engine import _align_full2

    B = min(len(pairs), pipe.cfg.batch_size)
    chunk = pairs[:B]
    caps = pipe._tier_caps(max(len(q) for q, _ in chunk),
                           max(len(t) for _, t in chunk), 0)
    eng = pipe._engine(caps.k_win, caps.s_cap, caps.w_win)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = eng._pack_all(chunk)
    packed = tp is not None
    seq = np.concatenate([qp if packed else qb, tp if packed else tbuf], 1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    dseq, dlens = jnp.asarray(seq), jnp.asarray(lens)

    def run():
        return _align_full2(dseq, dlens, cfg=eng.cfg, B=B, Lq=Lq, Ltb=Ltb,
                            packed=packed, flat=True)

    out = run()  # warm (compile cached from the wall-clock run)
    key = "mtb" if "mtb" in out else next(iter(out))
    np.asarray(out[key][:1])
    for a in out.values():
        a.delete()
    t0 = time.perf_counter()
    outs = [run() for _ in range(k_runs)]
    np.asarray(outs[-1][key][:1])
    per = (time.perf_counter() - t0) / k_runs
    for o in outs:
        for a in o.values():
            a.delete()
    return round(B / per, 1)


def _run(pipe, n, length, err, reps=3):
    from wfa_tpu.datagen import generate_pairs

    pairs = generate_pairs(n, length, err, seed=42)
    pipe.align_all(pairs)  # warm: compiles every shape/tier this touches
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = pipe.align_all(pairs)
        times.append(time.perf_counter() - t0)
    assert len(results) == n and all(r is not None for r in results)
    # best-of-N is reported; all reps are printed
    if len(times) > 1:
        print(f"# reps: {[round(t, 3) for t in times]} s (best-of-"
              f"{len(times)} reported)", file=sys.stderr)
    elapsed = min(times)
    return n / elapsed, elapsed, results[0], pairs


def _backend_name() -> str:
    import jax

    d = jax.devices()[0]
    return f"{jax.default_backend()}:{getattr(d, 'device_kind', '?')}"


def main() -> None:
    require_gpu()
    from wfa_tpu import (AdaptiveReductionOption, Options, Penalties,
                         enable_compile_cache)
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    enable_compile_cache()
    cfg = PipelineConfig(
        penalties=Penalties(4, 6, 2),
        options=Options(global_alignment=True),
        adaptive=AdaptiveReductionOption(10, 50, 1),
        batch_size=int(os.environ.get("WFA_BENCH_BATCH", "2048")),
    )
    pipe = AlignmentPipeline(cfg)

    if os.environ.get("WFA_BENCH_MATRIX"):
        # the reference's full matrix (benchmark.tsv); Go aln/s derived
        # from its recorded times (n / time).  Rows are printed to stderr
        # and written to a JSON file.
        rows = [
            (1000, 0.05, 6484), (1000, 0.10, 2393), (1000, 0.20, 904),
            (50000, 0.05, 81.9), (50000, 0.10, 27.9), (50000, 0.20, 10.4),
            # 100kb ONT-like reads: beyond the reference's own benchmark
            # ceiling (benchmark.tsv stops at 50k); Go number extrapolated
            # from its 50k scaling (~0.25x per doubling) for reference only
            (100000, 0.05, 20.0),
        ]
        record = []
        for length, err, go in rows:
            n = 65536 if length <= 1000 else (64 if length <= 50000 else 32)
            # 3 reps everywhere: the first call at a fresh score-cap fit
            # compiles, the second compiles its trim-slice program — the
            # third is the steady state
            reps = 3
            aln_s, elapsed, _, pairs = _run(pipe, n, length, err, reps=reps)
            dev_only = _device_only(pipe, pairs) if length <= 1000 else None
            print(f"# l={length} e={err}: {aln_s:.1f} aln/s "
                  f"(Go {go}; {aln_s / go:.1f}x) n={n} {elapsed:.2f}s "
                  f"dev_only={dev_only}", file=sys.stderr)
            record.append({
                "mode": "global", "l": length, "e": err, "n": n,
                "reps": reps, "aln_per_s": round(aln_s, 1),
                "elapsed_s": round(elapsed, 3),
                "device_only_aln_per_s": dev_only,
                "go_aln_per_s": go, "vs_go": round(aln_s / go, 2),
            })
        # semi-global rows.  benchmark.tsv records no Go semi-global
        # numbers; go_est uses the Go GLOBAL rate at the same l/e as an
        # upper-bound estimate (wf-adaptive trims the full-span seed to
        # a global-like band within a few scores, so the reference's
        # semi-global runs at most at its global speed; its end-finder
        # scan only adds work).
        semi = AlignmentPipeline(dataclasses.replace(
            cfg, options=Options(global_alignment=False)))
        semi_rows = [(200, 0.05, None), (1000, 0.05, 6484),
                     (1000, 0.10, 2393), (1000, 0.20, 904),
                     (10000, 0.05, 648)]
        for length, err, go_est in semi_rows:
            n = (8192 if length <= 1000 else 64)
            aln_s, elapsed, _, _ = _run(semi, n, length, err, reps=3)
            vs = f" (Go est {go_est}; {aln_s / go_est:.1f}x)" if go_est else ""
            print(f"# semi-global l={length} e={err}: {aln_s:.1f} aln/s"
                  f"{vs} n={n} {elapsed:.2f}s", file=sys.stderr)
            record.append({
                "mode": "semi-global", "l": length, "e": err, "n": n,
                "reps": 3, "aln_per_s": round(aln_s, 1),
                "elapsed_s": round(elapsed, 3),
                "go_aln_per_s": None,
                "go_est_aln_per_s": go_est,
                "vs_go_est": (round(aln_s / go_est, 2) if go_est else None),
            })
        out_path = os.environ.get(
            "WFA_BENCH_MATRIX_OUT", "bench_matrix.json")
        with open(out_path, "w") as fh:
            json.dump({"backend": _backend_name(), "card": card_line(),
                       "rows": record}, fh, indent=1)
            fh.write("\n")
        print(f"# matrix written to {out_path}", file=sys.stderr)
        return

    aln_s, elapsed, r0, pairs = _run(pipe, N_PAIRS, LENGTH, ERROR_RATE)
    dev_only = _device_only(pipe, pairs)
    print(
        f"# n={N_PAIRS} l={LENGTH} e={ERROR_RATE} elapsed={elapsed:.2f}s "
        f"sample: score={r0.score} cigar_len={len(r0.ops)}; "
        f"device-only {dev_only} aln/s; device {_backend_name()}",
        file=sys.stderr,
    )
    print(card_line())
    print(
        json.dumps(
            {
                "metric": "alignments/sec/chip on 1kb seq pairs (global, gap-affine)",
                "value": round(aln_s, 1),
                "unit": "alignments/sec",
                "vs_baseline": round(aln_s / BASELINE_ALN_S, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
