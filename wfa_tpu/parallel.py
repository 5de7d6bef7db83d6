"""Data-parallel execution over a device mesh.

Pairwise alignment is embarrassingly parallel, so the one applicable
parallelism strategy is data parallelism: the pair batch is sharded over
a 1-D mesh (``dp`` axis) with ``shard_map``; each device runs the full
lockstep score loop on its shard and the only collectives are output
gathers (the reference has no distributed machinery at all —
concurrency is pushed to the caller, wfa.go:74-77).  Every device pair
is equally close, so the mesh needs no topology.

Multi-process: `jax.distributed.initialize()` before building the mesh;
the same code then runs over the global mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .engine import (EngineConfig, _State, _align_full2_impl,
                     _run_batch_impl)

# [S, B, K] histories / [S, B] bands shard along the batch axis (axis 1).
_STATE_SPECS = _State(
    s=P(),
    done=P("dp"), overflow=P("dp"), final_s=P("dp"),
    hist_m=P(None, "dp", None), hist_i=P(None, "dp", None),
    hist_d=P(None, "dp", None),
    aux_m=P(None, "dp", None), aux_i=P(None, "dp", None),
    aux_d=P(None, "dp", None),
    lo_m=P(None, "dp"), hi_m=P(None, "dp"),
    lo_i=P(None, "dp"), hi_i=P(None, "dp"),
    lo_d=P(None, "dp"), hi_d=P(None, "dp"),
    ex_m=P(None, "dp"), ex_i=P(None, "dp"), ex_d=P(None, "dp"),
)

_IN_SPECS = (P("dp"), P("dp"), P("dp"), P("dp"), P("dp"))


def make_dp_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("dp",))


def _local_b(B: int, mesh: Mesh) -> int:
    n_dev = mesh.devices.size
    assert B % n_dev == 0, f"batch {B} not divisible by mesh size {n_dev}"
    return B // n_dev


def dp_align_state(
    qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, mesh: Mesh,
    Lq: int, Ltb: int,
):
    """Run the score loop data-parallel over the mesh.

    Returns the full per-pair final state (globally sharded along the
    batch axis) and a psum-reduced pair-done count (a collective).
    """
    lb = _local_b(qb.shape[0], mesh)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=_IN_SPECS,
        out_specs=(_STATE_SPECS, P()),
        check_vma=False,
    )
    def _sharded(qb_s, tb_s, ql_s, tl_s, to_s):
        st = _run_batch_impl(
            qb_s, tb_s, ql_s, tl_s, to_s, cfg=cfg, B=lb, Lq=Lq, Ltb=Ltb
        )
        n_done = lax.psum(jnp.sum(st.done.astype(jnp.int32)), "dp")
        return st, n_done

    return jax.jit(_sharded)(qb, tbuf, qlen, tlen, toff)


def initialize_distributed(**kwargs) -> int:
    """Multi-process entry: `jax.distributed.initialize`, idempotent;
    returns the process count.  Single-process runs (no
    coordinator configured) are a no-op."""
    import os

    if jax.process_count() > 1:
        return jax.process_count()
    if kwargs or os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
            "COORDINATOR_ADDRESS"):
        jax.distributed.initialize(**kwargs)
    return jax.process_count()


_DP_FULL_CACHE: dict = {}


def dp_align_full_fn(cfg: EngineConfig, mesh: Mesh, B: int, Lq: int,
                     Ltb: int, packed: bool = False):
    """Cached jitted data-parallel full-alignment step.

    One compilation per (cfg, mesh, shapes) — the production pipeline
    calls this per batch, so the shard_map closure must not be rebuilt
    each time (a fresh `jax.jit` per call would recompile every batch).
    """
    key = (cfg, mesh, B, Lq, Ltb, packed)
    fn = _DP_FULL_CACHE.get(key)
    if fn is not None:
        return fn

    from .engine import _token_plan

    lb = B // mesh.devices.size
    assert B % mesh.devices.size == 0
    _, compact = _token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
    if compact:
        out_specs = {"mt": P("dp")}  # merged meta|compacted-tokens
    else:
        out_specs = {"meta": P("dp"), "tok0": P("dp"),
                     "buf": P(None, "dp", None), "tail": P("dp")}

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),  # combined (seq, lens) uploads
        out_specs=out_specs,
        check_vma=False,
    )
    def _sharded(seq_s, lens_s):
        return _align_full2_impl(
            seq_s, lens_s, cfg=cfg, B=lb, Lq=Lq, Ltb=Ltb, packed=packed,
        )

    fn = jax.jit(_sharded)
    _DP_FULL_CACHE[key] = fn
    return fn


def dp_align_full(
    qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, mesh: Mesh,
    Lq: int, Ltb: int, packed: bool = False,
):
    """Full data-parallel alignment (score loop + device backtrace).

    Returns the compact per-pair outputs dict, batch-sharded — only op
    tokens and scalars leave the devices, never the wavefront history.
    """
    fn = dp_align_full_fn(cfg, mesh, qb.shape[0], Lq, Ltb, packed)
    seq = jnp.concatenate([qb, tbuf], axis=1)
    lens = jnp.stack([qlen.astype(jnp.int32), tlen.astype(jnp.int32),
                      toff.astype(jnp.int32)], axis=1)
    return fn(seq, lens)


def dp_align_scores(
    qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, mesh: Mesh,
    Lq: int, Ltb: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scores-only data-parallel alignment: returns (final_s, done) [B]."""
    lb = _local_b(qb.shape[0], mesh)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=_IN_SPECS,
        out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    def _sharded(qb_s, tb_s, ql_s, tl_s, to_s):
        st = _run_batch_impl(
            qb_s, tb_s, ql_s, tl_s, to_s, cfg=cfg, B=lb, Lq=Lq, Ltb=Ltb
        )
        return st.final_s, st.done

    return jax.jit(_sharded)(qb, tbuf, qlen, tlen, toff)
