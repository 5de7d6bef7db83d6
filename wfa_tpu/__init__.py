"""wfa_tpu — a batched wavefront-alignment (WFA) framework on JAX.

A from-scratch JAX/XLA re-design of the gap-affine wavefront
alignment algorithm (Marco-Sola et al. 2020) with the same capabilities
and bit-identical outputs (scores, CIGARs, coordinates, stats) as the
reference Go implementation:

* distance metric: gap-affine
* alignment types: global, semi-global
* heuristic: wf-adaptive reduction

Layers:

* :mod:`wfa_tpu.oracle`  — exact scalar executable spec (correctness oracle)
* :mod:`wfa_tpu.engine`  — batched device score-loop engine (JAX / XLA)
* :mod:`wfa_tpu.cigar`   — CIGAR op-runs, stats, text rendering
* :mod:`wfa_tpu.pipeline`— bucketing, tiered retry, batch streaming
* :mod:`wfa_tpu.parallel`— data-parallel sharding over device meshes
* :mod:`wfa_tpu.cli`     — the ``wfa-tpu`` command-line tool
"""

import os

from .cigar import AlignmentResult
from .constants import (
    DEFAULT_ADAPTIVE,
    DEFAULT_OPTIONS,
    DEFAULT_PENALTIES,
    MAX_SEQ_LEN,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from .oracle import Aligner as OracleAligner
from .oracle import align as oracle_align

__version__ = "0.3.0"


def __getattr__(name):
    # lazy device-stack exports: keep `import wfa_tpu` light (the oracle
    # path needs no jax); the batched/parallel API loads on first touch
    if name in ("BatchAligner", "EngineConfig"):
        from . import engine

        return getattr(engine, name)
    if name in ("AlignmentPipeline", "PipelineConfig"):
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory
    and return it.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set.  Otherwise the cache is
    ``.jax_cache`` at the root of the checkout: a path that never
    changes between runs, since the directory is part of what lets a
    later process find an earlier one's programs."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


# -- recycling API parity --------------------------------------------------
# The reference exposes sync.Pool-based object recycling as part of its API
# contract (README.md:82-84, 207-214; wfa.go:102, wfa_cigar.go:92).  The
# batched framework's state is functional/preallocated, so recycling is a
# no-op — these exist so reference callers can port code unchanged.

def recycle_aligner(aligner) -> None:
    """No-op (RecycleAligner, wfa.go:102): nothing to pool here."""


def recycle_alignment_result(result) -> None:
    """No-op (RecycleAlignmentResult, wfa_cigar.go:92)."""


def recycle_alignment_text(q, a, t) -> None:
    """No-op (RecycleAlignmentText, wfa_cigar.go:347)."""


def recycle_component(component) -> None:
    """No-op (RecycleComponent, wfa_component.go:74)."""


def recycle_wave_front(wavefront) -> None:
    """No-op (RecycleWaveFront, wfa_wavefront.go:70)."""


__all__ = [
    "AlignmentPipeline",
    "AlignmentResult",
    "AdaptiveReductionOption",
    "BatchAligner",
    "EngineConfig",
    "PipelineConfig",
    "DEFAULT_ADAPTIVE",
    "DEFAULT_OPTIONS",
    "DEFAULT_PENALTIES",
    "EmptySeqError",
    "MAX_SEQ_LEN",
    "Options",
    "OracleAligner",
    "Penalties",
    "SeqTooLongError",
    "enable_compile_cache",
    "oracle_align",
    "recycle_aligner",
    "recycle_alignment_result",
    "recycle_alignment_text",
    "recycle_component",
    "recycle_wave_front",
]
