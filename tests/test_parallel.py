"""Sharding tests on the virtual 8-device CPU mesh.

Data-parallel results must match single-device results exactly — the
stand-in for multi-card tests (no real multi-card hardware needed).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _packed_batch(B, L, k_win, seed=3):
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu.engine import BatchAligner

    pairs = generate_pairs(B, L, 0.15, seed=seed)
    packer = BatchAligner(
        Penalties(), Options(True), AdaptiveReductionOption(),
        k_win=k_win, s_cap=128,
    )
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packer.pack_batch(pairs)
    args = tuple(jnp.asarray(a) for a in (qb, tbuf, qlen, tlen, toff))
    return pairs, args, Lq, Ltb


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_dp_scores_match_single_device():
    from wfa_tpu import AdaptiveReductionOption, Penalties
    from wfa_tpu.engine import EngineConfig, _run_batch
    from wfa_tpu.parallel import dp_align_scores, make_dp_mesh

    B, L, K = 16, 48, 128
    cfg = EngineConfig(
        penalties=Penalties(),
        global_alignment=True,
        adaptive=AdaptiveReductionOption(),
        k_win=K,
        s_cap=128,
    )
    pairs, args, Lq, Ltb = _packed_batch(B, L, K)

    st_single = _run_batch(*args, cfg=cfg, B=B, Lq=Lq, Ltb=Ltb)
    mesh = make_dp_mesh(8)
    scores, done = dp_align_scores(*args, cfg=cfg, mesh=mesh, Lq=Lq, Ltb=Ltb)
    np.testing.assert_array_equal(np.asarray(scores), np.asarray(st_single.final_s))
    np.testing.assert_array_equal(np.asarray(done), np.asarray(st_single.done))
    assert bool(np.all(np.asarray(done))), "all pairs should finish within caps"


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_dp_full_matches_oracle():
    """Sharded full path (score+backtrace) decodes to oracle results."""
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties, OracleAligner
    from wfa_tpu.engine import BatchAligner, EngineConfig
    from wfa_tpu.parallel import dp_align_full, make_dp_mesh

    B, L, K = 16, 48, 128
    cfg = EngineConfig(
        penalties=Penalties(),
        global_alignment=True,
        adaptive=AdaptiveReductionOption(),
        k_win=K,
        s_cap=128,
    )
    pairs, args, Lq, Ltb = _packed_batch(B, L, K)
    mesh = make_dp_mesh(8)
    out = jax.device_get(
        dp_align_full(*args, cfg=cfg, mesh=mesh, Lq=Lq, Ltb=Ltb)
    )
    ba = BatchAligner(
        Penalties(), Options(True), AdaptiveReductionOption(),
        k_win=K, s_cap=128,
    )
    results = ba._finish(pairs, out, fallback=True)
    oracle = OracleAligner(Penalties(), Options(True), AdaptiveReductionOption())
    for (q, t), res in zip(pairs, results):
        want = oracle.align(q, t)
        assert res.score == want.score
        assert res.cigar(False) == want.cigar(False)


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    scores, cnt, overflow = jax.device_get(out)
    assert scores.shape == (8,)
    assert not overflow.any()
    assert (cnt > 0).all()


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_pipeline_uses_mesh_and_matches_single_device():
    """The production pipeline must shard batches over the mesh (not just
    the raw dp functions) and return results identical to a single-device
    pipeline, including ragged batches that need mesh padding."""
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    base = dict(penalties=Penalties(4, 6, 2), options=Options(True),
                adaptive=AdaptiveReductionOption(10, 50, 1), batch_size=16)
    pairs = generate_pairs(35, 60, 0.1, seed=11)  # 35 : ragged everywhere
    multi = AlignmentPipeline(PipelineConfig(**base, n_devices=8))
    single = AlignmentPipeline(PipelineConfig(**base, n_devices=1))
    assert multi._mesh is not None and multi._mesh.devices.size == 8
    assert single._mesh is None
    rm = multi.align_all(pairs)
    rs = single.align_all(pairs)
    for (q, t), a, b in zip(pairs, rm, rs):
        assert a.score == b.score, (q, t)
        assert a.cigar(False) == b.cigar(False), (q, t)
        for attr in ("q_begin", "q_end", "t_begin", "t_end", "align_len",
                     "matches", "gaps", "gap_regions"):
            assert getattr(a, attr) == getattr(b, attr), (attr, q, t)


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_graft_dryrun_multichip_full_path():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_mesh_padding_raw_token_path():
    """Mesh-padded ragged batches through the RAW (int32) token path:
    device tensors carry padded rows, and the decode must size by them,
    not by the unpadded pair count (review finding: reshape crash that
    silently burned the device-fault budget)."""
    from wfa_tpu import Options, Penalties
    from wfa_tpu.engine import BatchAligner
    from wfa_tpu.parallel import make_dp_mesh

    # small penalty steps blow the compact-token key bound -> raw path
    eng = BatchAligner(Penalties(8, 6, 1), Options(True), None,
                      k_win=64, s_cap=65536, mesh=make_dp_mesh(4))
    from wfa_tpu import OracleAligner

    oracle = OracleAligner(Penalties(8, 6, 1), Options(True), None)
    pairs = [(b"ACGTACGTAC", b"ACGAACGTAC"), (b"ACGT", b"AGGT"),
             (b"ACCTG", b"ACCTG")]  # 3 pairs over 4 devices: padded
    for (q, t), res in zip(pairs, eng.align_batch(pairs)):
        ref = oracle.align(q, t)
        assert res.score == ref.score and res.cigar(False) == ref.cigar(False)


_MULTIHOST_WORKER = r"""
import os, sys, pickle
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
assert jax.process_count() == 2, jax.process_count()
from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

cfg = PipelineConfig(
    penalties=Penalties(4, 6, 2), options=Options(True),
    adaptive=AdaptiveReductionOption(10, 50, 1), batch_size=8)
pipe = AlignmentPipeline(cfg)
assert pipe._mesh is not None and pipe._mesh.devices.size == jax.device_count()
pairs = generate_pairs(12, 50, 0.1, seed=33)
results = pipe.align_all(pairs)
# the DEVICE path must have produced these (a fetch failure would fall
# back to the host oracle and still "pass" — a silently untested path)
assert pipe.device_faults == 0, pipe.device_faults
assert pipe.oracle_pairs == 0, pipe.oracle_pairs
digest = [(r.score, r.cigar(False), r.align_len, r.matches) for r in results]
print("DIGEST:" + repr(digest))

# semi-global multi-process: the full-span window over the global mesh
scfg = PipelineConfig(
    penalties=Penalties(4, 6, 2), options=Options(False),
    adaptive=AdaptiveReductionOption(10, 50, 1), batch_size=6)
spipe = AlignmentPipeline(scfg)
spairs = generate_pairs(6, 280, 0.06, seed=77)
sres = spipe.align_all(spairs)
assert spipe.device_faults == 0, spipe.device_faults
assert spipe.oracle_pairs == 0, spipe.oracle_pairs
assert all(k[0] >= 2 * 280 for k in spipe._engines), (
    "semi-global window narrower than the full diagonal span")
sdigest = [(r.score, r.cigar(False), r.align_len, r.matches) for r in sres]
print("SDIGEST:" + repr(sdigest))
"""


@pytest.mark.slow
def test_multihost_two_process_cpu():
    """Real multi-process execution: two jax.distributed processes on a
    CPU mesh run the full pipeline (global jax.Arrays via
    make_array_from_callback, engine.py) and must agree with the
    single-process oracle (VERDICT r2 item 4; SURVEY §4's prescribed
    multi-host CPU-mesh fake)."""
    import socket
    import subprocess
    import sys

    from wfa_tpu import (AdaptiveReductionOption, Options, OracleAligner,
                         Penalties)
    from wfa_tpu.datagen import generate_pairs

    with socket.socket() as s:  # pick a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST_WORKER, coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)
    digests, sdigests = [], []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("DIGEST:")]
        assert line, out
        digests.append(eval(line[0][len("DIGEST:"):]))
        sline = [l for l in out.splitlines() if l.startswith("SDIGEST:")]
        assert sline, out
        sdigests.append(eval(sline[0][len("SDIGEST:"):]))
    assert digests[0] == digests[1], "processes disagree"
    assert sdigests[0] == sdigests[1], "processes disagree (semi-global)"
    oracle = OracleAligner(Penalties(4, 6, 2), Options(True),
                           AdaptiveReductionOption(10, 50, 1))
    pairs = generate_pairs(12, 50, 0.1, seed=33)
    expect = [
        (r.score, r.cigar(False), r.align_len, r.matches)
        for r in (oracle.align(q, t) for q, t in pairs)
    ]
    assert digests[0] == expect
    soracle = OracleAligner(Penalties(4, 6, 2), Options(False),
                            AdaptiveReductionOption(10, 50, 1))
    spairs = generate_pairs(6, 280, 0.06, seed=77)
    sexpect = [
        (r.score, r.cigar(False), r.align_len, r.matches)
        for r in (soracle.align(q, t) for q, t in spairs)
    ]
    assert sdigests[0] == sexpect


@pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)
def test_pipeline_mesh_realistic_length():
    """Mesh pipeline at l~800 with realistic score caps: the
    compact-token path at real trim sizes, ragged over 8 shards,
    bit-exact vs the oracle (VERDICT r2 weak item 4 — mesh tests were
    tiny)."""
    from wfa_tpu import (AdaptiveReductionOption, Options, OracleAligner,
                         Penalties)
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu.pipeline import AlignmentPipeline, PipelineConfig

    cfg = PipelineConfig(
        penalties=Penalties(4, 6, 2), options=Options(True),
        adaptive=AdaptiveReductionOption(10, 50, 1), batch_size=11)
    pipe = AlignmentPipeline(cfg)
    assert pipe._mesh is not None and pipe._mesh.devices.size == 8
    pairs = generate_pairs(11, 800, 0.06, seed=41)  # ragged: 11 -> pad 16
    results = pipe.align_all(pairs)
    oracle = OracleAligner(cfg.penalties, cfg.options, cfg.adaptive)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.score == ref.score, (q, t)
        assert res.cigar(False) == ref.cigar(False), (q, t)
        assert (res.q_begin, res.q_end, res.t_begin, res.t_end) == (
            ref.q_begin, ref.q_end, ref.t_begin, ref.t_end)
        assert (res.align_len, res.matches, res.gaps, res.gap_regions) == (
            ref.align_len, ref.matches, ref.gaps, ref.gap_regions)
