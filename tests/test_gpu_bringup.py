"""The single XLA score-loop path and what surrounds it on every platform:
long global reads through windowed stop-table reads, tier caps and batch
admission against a device-derived memory budget, the compile cache, the
pipeline's fault and oracle counters, and chip_smoke.py's refusal to run
without a GPU."""

import os
import subprocess
import sys
import uuid

import pytest

import jax

import wfa_tpu
from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner
from wfa_tpu.oracle import Aligner as OracleAligner
from wfa_tpu.pipeline import (BUDGET_FRACTION, HOST_BUDGET, AlignmentPipeline,
                              PipelineConfig, TierCaps, device_memory_budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEN = Penalties(4, 6, 2)
ADA = AdaptiveReductionOption(10, 50, 1)
GIB = 1 << 30
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")


def _pipe(glob=True, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("n_devices", 1)
    return AlignmentPipeline(PipelineConfig(PEN, Options(glob), ADA, **kw))


def _assert_oracle(pairs, results, glob=True):
    oracle = OracleAligner(PEN, Options(glob), ADA)
    for (q, t), r in zip(pairs, results):
        o = oracle.align(q, t)
        assert r.cigar(False) == o.cigar(False), (q[:30], t[:30])
        for f in FIELDS:
            assert getattr(r, f) == getattr(o, f), f


# -- long global reads: the windowed XLA engine ------------------------------

@pytest.mark.parametrize("l,e", [(4200, 0.05), (5000, 0.02)])
def test_long_global_windowed_pipeline(l, e):
    pipe = _pipe()
    pairs = generate_pairs(2, l, e, seed=l)
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0
    assert [w for _, _, w in pipe._engines] == [128]  # tier 0 served all


def _spread_pairs():
    # a near-identical pair races ahead of a noisy one: past ~128 words
    # of progress spread it outruns the tier-0 read window (anchored at
    # the batch's slowest live word) long before its score cap
    return (generate_pairs(1, 4200, 0.002, seed=1)
            + generate_pairs(1, 4200, 0.08, seed=2))


def test_long_global_outrun_escapes_tier0_window():
    eng = BatchAligner(PEN, Options(True), ADA, k_win=256, s_cap=2560,
                       w_win=128)
    pairs = _spread_pairs()
    fast, slow = eng.align_batch(pairs, fallback=False)
    assert fast is None  # outran the window: overflow, never a wrong answer
    _assert_oracle(pairs[1:], [slow])


def test_long_global_window_outrun_retry():
    """The pipeline retries the outrun pair on tier 1's wider read
    window and finishes every pair on the device."""
    pipe = _pipe()
    pairs = _spread_pairs()
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert [w for _, _, w in pipe._engines] == [128, 256]
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0


# -- tier caps: the XLA engine, and batches that fit the budget -------------

@pytest.mark.parametrize("glob", [True, False], ids=["global", "semi"])
@pytest.mark.parametrize("l", [100, 1000, 4096, 6000, 20000])
def test_tier_caps_grid_fits_budget(glob, l):
    for budget in (256 << 20, 8 * GIB, 30 * GIB):
        pipe = _pipe(glob, hbm_budget=budget, batch_size=2048)
        for tier in (0, 1, 2, 3):
            caps = pipe._tier_caps(l, l + 7, tier)
            assert isinstance(caps, TierCaps)
            assert TierCaps._fields == ("k_win", "s_cap", "w_win", "b_cap",
                                        "batch_bytes")
            if not glob:
                assert caps.k_win >= 2 * l + 7  # every diagonal
            if caps.b_cap == 0:  # not even one pair fits: oracle route
                assert budget < 8 * GIB or l > 4096
                continue
            assert caps.s_cap >= 8
            assert 0 < caps.batch_bytes <= budget, (budget, tier, caps)
            if glob and l <= 6000 and budget >= 8 * GIB:
                assert caps.b_cap >= 1
            eng = pipe._engine(caps.k_win, caps.s_cap, caps.w_win)
            assert isinstance(eng, BatchAligner)
            assert not hasattr(eng, "engine")  # one score-loop path


# -- the device memory budget ------------------------------------------------

class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60_000_000_000}, int(60_000_000_000 * BUDGET_FRACTION)),
    ({"bytes_in_use": 5}, HOST_BUDGET),
    (None, HOST_BUDGET),
], ids=["reported", "no-limit", "cpu"])
def test_budget_from_memory_stats(monkeypatch, stats, want):
    monkeypatch.delenv("WFA_HBM_BUDGET", raising=False)
    assert device_memory_budget(_Dev(stats)) == want


def test_budget_env_override(monkeypatch):
    monkeypatch.setenv("WFA_HBM_BUDGET", "1500")
    assert device_memory_budget(_Dev({"bytes_limit": 8 * GIB})) == 1500 << 20


def test_pipeline_budget_follows_device(monkeypatch):
    """The pipeline takes its budget from the device it runs on; an
    explicit PipelineConfig.hbm_budget wins."""
    monkeypatch.delenv("WFA_HBM_BUDGET", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: [_Dev({"bytes_limit": 64 * GIB})])
    assert _pipe().hbm_budget == int(64 * GIB * BUDGET_FRACTION)
    assert _pipe(hbm_budget=3 * GIB).hbm_budget == 3 * GIB


# -- the persistent compile cache --------------------------------------------

_CACHE_PROBE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
sys.path.insert(0, sys.argv[1])
import wfa_tpu
print(wfa_tpu.enable_compile_cache())
jax.jit(lambda x: x * {nonce} + 1)(jax.numpy.arange(7)).block_until_ready()
"""


def _cache_probe(env):
    code = _CACHE_PROBE.replace("{nonce}", str(uuid.uuid4().int % (1 << 30) + 7))
    r = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: compiled programs land there."""
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_probe(env) == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_compile_cache_default_dir():
    """Unset: programs land in the checkout's fixed, gitignored
    .jax_cache directory."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    path = os.path.join(REPO, ".jax_cache")
    before = set(os.listdir(path)) if os.path.isdir(path) else set()
    assert _cache_probe(env) == path
    assert set(os.listdir(path)) - before
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_path_is_stable(monkeypatch):
    """Two calls give the same path (never a temporary name, a pid or
    the time), and the env var wins over the default."""
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = wfa_tpu.enable_compile_cache()
        assert first == wfa_tpu.enable_compile_cache()
        assert first == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert wfa_tpu.enable_compile_cache() == "/elsewhere/cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# -- the pipeline's per-call fault and oracle counters -----------------------

def test_counters_clean_run():
    pipe = _pipe()
    pairs = generate_pairs(6, 80, 0.1, seed=5) + [(b"", b"ACGT")]
    res = pipe.align_all(pairs)
    _assert_oracle(pairs[:-1], res[:-1])
    assert res[-1].error is not None  # invalid input is not a fallback
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0


def test_counters_device_faults(monkeypatch):
    pipe = _pipe()

    def failing(self, pairs, *a, **k):
        raise RuntimeError("device runtime error")

    monkeypatch.setattr(BatchAligner, "submit_batch", failing)
    pairs = generate_pairs(5, 60, 0.1, seed=6)
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.device_faults == 2 and pipe.oracle_pairs == 5


def test_counters_budget_too_small_for_one_pair():
    """A class no single pair of which fits the budget goes straight to
    the oracle, counted, with no device fault."""
    pipe = _pipe(hbm_budget=16 << 10)
    assert pipe._tier_caps(200, 200, 0).b_cap == 0
    pairs = generate_pairs(3, 200, 0.05, seed=7)
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 3
    assert not pipe._engines


def test_counters_reset_per_call(monkeypatch):
    pipe = _pipe()
    pairs = generate_pairs(3, 60, 0.1, seed=8)
    orig = BatchAligner.submit_batch

    def failing(self, pairs, *a, **k):
        raise RuntimeError("device runtime error")

    monkeypatch.setattr(BatchAligner, "submit_batch", failing)
    pipe.align_all(pairs)
    assert pipe.device_faults == 2 and pipe.oracle_pairs == 3
    monkeypatch.setattr(BatchAligner, "submit_batch", orig)
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.device_faults == 0 and pipe.oracle_pairs == 0


def test_pipeline_probe_skips_doomed_tier(monkeypatch):
    """When >90% of the probe chunk overflows tier 0, the remaining
    chunks skip straight to the next tier (pipeline.skip_rest) — and the
    results are still exact, all on the device."""
    pipe = _pipe(batch_size=16, n_devices=0)
    # e=0.45 at l=150: scores ~550 blow tier 0's 256 cap for every pair
    pairs = generate_pairs(96, 150, 0.45, seed=3)
    calls = []
    orig = BatchAligner.submit_batch

    def counting(self, batch, *a, **k):
        calls.append(len(batch))
        return orig(self, batch, *a, **k)

    monkeypatch.setattr(BatchAligner, "submit_batch", counting)
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.oracle_pairs == 0
    # tier 0: 6 chunks exist, but the probe reports >=90% overflow so
    # later chunks never submit.  Without the skip there would be >= 12
    # submits.
    assert len(calls) <= 10, calls


# -- chip_smoke.py refuses to run without a GPU -------------------------------

def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
