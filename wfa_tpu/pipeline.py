"""High-throughput alignment pipeline: bucketing + tiered window retry.

This is the framework's batching orchestrator (the reference has none —
its CLI aligns one pair at a time, wfa-go.go:166-178).  Pairs are grouped
into length classes (one jit compilation per class), run through the
device engine with economical window caps, and the rare pairs whose band
or score overflows are retried with larger caps before falling back to
the exact host oracle.  Results always come back in input order and are
bit-identical to the oracle regardless of which tier served them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

from .cigar import AlignmentResult
from .constants import (MAX_SEQ_LEN, AdaptiveReductionOption, EmptySeqError,
                        Options, Penalties, SeqTooLongError)
from .engine import BatchAligner
from .io import bucket_pairs
from .oracle import Aligner as OracleAligner


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


# Share of the device allocator's limit that batch admission may fill
# with modeled footprint: the models in _tier_caps sit above the
# measured peaks, and XLA's temporaries come on top of them.
BUDGET_FRACTION = 0.5
# Admission budget where the device reports no allocator limit (the CPU
# backend, whose "device memory" is host memory shared with everything
# else on the machine).
HOST_BUDGET = 8 << 30
# Modeled bytes per [score, pair, diagonal] cell of the score loop: six
# int32 history planes carried through the while loop, the stacked aux
# copy the backtrace reads, and loop temporaries.
CELL_BYTES = 40


def device_memory_budget(device=None) -> int:
    """Bytes of modeled device footprint one alignment call may admit.

    ``WFA_HBM_BUDGET`` (MiB) overrides.  Otherwise a fixed share of the
    allocator limit the device reports (``memory_stats()["bytes_limit"]``),
    or HOST_BUDGET where it reports none."""
    env = os.environ.get("WFA_HBM_BUDGET")
    if env:
        return int(env) << 20
    if device is None:
        import jax

        device = jax.local_devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    return int(limit * BUDGET_FRACTION) if limit else HOST_BUDGET


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    penalties: Penalties = Penalties()
    options: Options = Options()
    adaptive: Optional[AdaptiveReductionOption] = None
    batch_size: int = 512
    use_device: bool = True
    # base score cap per unit of sequence length (tier 1); tier 2 multiplies
    s_cap_base: int = 256
    k_win_base: int = 128
    # device-memory budget for one call's in-flight batches; bounds the
    # batch size for long sequences (S grows with length).  None derives
    # it from the device (device_memory_budget).
    hbm_budget: Optional[int] = None
    # data parallelism over the local (or, after
    # parallel.initialize_distributed, global) device mesh: 0 = all
    # available devices, 1 = single-device, n = first n devices
    n_devices: int = 0


class TierCaps(NamedTuple):
    """Engine caps and batch admission for one length class at one tier."""

    k_win: int  # diagonal window width
    s_cap: int  # score cap (max score + 1)
    w_win: Optional[int]  # stop-table read window in words; None = all
    b_cap: int  # pairs per batch; 0 = not even one pair fits the budget
    batch_bytes: int  # modeled device footprint of one full batch


class AlignmentPipeline:
    """Aligns arbitrary streams of pairs at batch throughput.

    After each :meth:`align_all`, ``device_faults`` counts the device
    errors that call caught and ``oracle_pairs`` the valid pairs it
    finished on the host oracle instead of the device."""

    def __init__(self, cfg: PipelineConfig) -> None:
        self.cfg = cfg
        self._oracle = OracleAligner(cfg.penalties, cfg.options, cfg.adaptive)
        self._engines = {}
        self.device_faults = 0
        self.oracle_pairs = 0
        self._pool = None  # lazy drain ThreadPoolExecutor (_drain_pool)
        self._spool = None  # lazy submit ThreadPoolExecutor (_submit_pool)
        self._isem = None  # lazy in-flight count semaphore (_inflight_sem)
        # adaptive score-cap memory: bucket class -> max observed final
        # score in the most recent align_all that completed pairs there
        # (see _tier_caps)
        self._score_memory = {}
        import threading

        self._mem_cv = threading.Condition()  # in-flight byte gate
        self._mem_used = 0  # modeled bytes of submitted-not-yet-drained batches
        self._mesh = None
        self.hbm_budget = cfg.hbm_budget or (
            device_memory_budget() if cfg.use_device else HOST_BUDGET)
        if cfg.use_device:
            import jax

            from . import enable_compile_cache

            enable_compile_cache()
            n = cfg.n_devices or len(jax.devices())
            if n > 1:
                from .parallel import make_dp_mesh

                self._mesh = make_dp_mesh(n)

    # -- window/cap policy ---------------------------------------------------

    def _tier_caps(self, lq: int, lt: int, tier: int, skey=None) -> TierCaps:
        """Window, score cap and batch admission for a class/tier.

        ``skey`` names the bucket for the adaptive score-cap memory
        (observed max final score per bucket class, recorded by
        align_all): a high-error workload's first call learns that
        final scores reach ~0.92*l and every later call starts tier 0
        at a fitted cap instead of burning a doomed 0.55*l pass — the
        same feedback also SHRINKS caps (and with them the memory
        models, so batches grow) for low-error workloads."""
        cfg = self.cfg
        full_span = _round_up(lq + lt - 1 + 2, 128)
        longest = max(lq, lt)
        if not cfg.options.global_alignment:
            # semi-global seeds every diagonal (wfa.go:163-183), so the
            # window holds the full span at every tier; the tiers raise
            # the score cap and widen the stop-table read window
            k_win = full_span
        elif cfg.adaptive is not None:
            # wf-adaptive trims the band to ~2*max_dist_diff around the
            # optimal path, whose diagonal drifts like a random walk —
            # measured whole-run extents: <=104 at l=1k, <=257 at l=50k
            # (20% error).  Tier 0 runs the tight window; escapees retry.
            band = 2 * (cfg.adaptive.max_dist_diff + 2)
            drift = int(0.75 * longest ** 0.5)
            k_win = min(full_span,
                        _round_up(max(cfg.k_win_base, band + drift), 128))
            if longest <= 4096:
                if tier == 1:
                    k_win = min(full_span, 4 * k_win)
                elif tier >= 2:
                    k_win = full_span
            # long sequences keep the tier-0 window: the optimal path's
            # diagonal drifts like a random walk (measured extent <= 257
            # at l=50k, e=0.2), and tier-0 escapes are usually stop-table
            # window outruns that resolve when the escapees regroup
        else:
            k_win = full_span
        # score ladder: ~0.29*l at 5% error, ~0.53*l at 10%, ~0.92*l at
        # 20% — tier 0 covers the common case, tier 1 heavy error rates
        worst = (
            cfg.penalties.mismatch * longest
            + cfg.penalties.gap_open
            + cfg.penalties.gap_ext * (abs(lq - lt) + 1)
            + 2
        )
        # a roomier tier 0 saves the two-pass cost for 10%-error
        # workloads (scores: 0.29*l at e=0.05, 0.53*l at e=0.1 — at
        # l=50k/e=0.1 a 0.35*l cap sent EVERY pair through a doomed
        # full-length tier-0 pass).  s_cap headroom is nearly free in
        # time (the loop exits when the batch finishes) and the memory
        # model bounds the batch size by it.
        frac = 0.55
        s1 = max(cfg.s_cap_base, _round_up(int(longest * frac), 128))
        smax = self._score_memory.get(skey) if skey is not None else None
        if smax is not None:
            # fitted cap: observed workload max + 20% headroom for
            # batch-to-batch spread, quantized so the jit cache is
            # stable across calls; the ladder above it is unchanged
            # (a workload shift that outruns the fit retries a tier up,
            # and the memory re-learns from that call's results)
            s1 = max(cfg.s_cap_base,
                     _round_up(int(smax * 1.2) + 16, 128))
        s_cap = (s1, 3 * s1, _round_up(worst + 2, 8))[min(tier, 2)]
        s_cap = min(s_cap, _round_up(worst + 2, 8))
        if longest <= 4096 and k_win <= 512:
            w_win = None
        elif longest <= 4096:
            # wide diagonal window (semi-global spans every diagonal) but
            # short sequences: window the per-step stop-table reads —
            # streaming the full tables would be hundreds of MB per step
            w_win = (32, 64, None)[min(tier, 2)]
        else:
            # retries regroup escapees, which shrinks their progress
            # spread
            w_win = (128, 256, 512)[min(tier, 2)]
        # per-pair footprint: the score-loop cells plus the stop tables
        # (words + first-stop-after, x3 for the build transient)
        lw = (lq + lt) // 32 + 8
        table = k_win * lw * 24
        # one pair must fit the budget: clamp the score cap to what its
        # history can hold (pairs scoring above it retry, then finish on
        # the host oracle)
        s_fit = (self.hbm_budget - table) // (k_win * CELL_BYTES)
        s_cap = min(s_cap, s_fit - s_fit % 8)
        if s_cap < 8:
            return TierCaps(k_win, s_cap, w_win, 0, 0)
        per_pair = s_cap * k_win * CELL_BYTES + table
        b_cap = min(8192, self.hbm_budget // per_pair)
        bs = min(cfg.batch_size, b_cap)
        return TierCaps(k_win, s_cap, w_win, b_cap, per_pair * bs)

    def _engine(self, k_win: int, s_cap: int, w_win) -> BatchAligner:
        key = (k_win, s_cap, w_win)
        eng = self._engines.get(key)
        if eng is None:
            eng = BatchAligner(
                self.cfg.penalties,
                self.cfg.options,
                self.cfg.adaptive,
                k_win=k_win,
                s_cap=s_cap,
                w_win=w_win,
                mesh=self._mesh,
            )
            self._engines[key] = eng
        return eng

    # -- main entry ------------------------------------------------------------

    def align_all(
        self, pairs: Sequence[Tuple[bytes, bytes]]
    ) -> List[AlignmentResult]:
        """Align pairs, returning results in input order."""
        pairs = list(pairs)
        results: List[Optional[AlignmentResult]] = [None] * len(pairs)
        # per-pair input guards (reference: per-call errors, wfa.go:204-209;
        # SURVEY §5: a bad pair must not poison the batch) — invalid pairs
        # become error-carrying results, the rest proceed normally
        valid: List[Tuple[int, Tuple[bytes, bytes]]] = []
        for i, (q, t) in enumerate(pairs):
            if len(q) == 0 or len(t) == 0:
                results[i] = AlignmentResult.failed(
                    EmptySeqError("wfa: invalid empty sequence"))
            elif len(q) > MAX_SEQ_LEN or len(t) > MAX_SEQ_LEN:
                results[i] = AlignmentResult.failed(SeqTooLongError(
                    f"wfa: sequences longer than {MAX_SEQ_LEN} are not "
                    "supported"))
            else:
                valid.append((i, (q, t)))
        if not self.cfg.use_device:
            for i, (q, t) in valid:
                results[i] = self._oracle.align(q, t)
            return results  # type: ignore[return-value]

        buckets = bucket_pairs(valid)
        # the device-fault budget is per call: a transient device error
        # must not permanently disable the device for a pipeline that
        # lives across a whole run
        self.device_faults = 0
        self.oracle_pairs = 0
        # one work-list per bucket, retried through up to 3 cap tiers.
        # All batches of a tier are submitted before any is collected,
        # and a small drain pool fetches+decodes finished batches on
        # worker threads WHILE the main thread keeps packing/submitting —
        # batch N's device->host transfers and Python decode overlap
        # batch N+1's host pack and the device's compute (the GIL is
        # released during the native pack, jax dispatch, and blocking
        # device_get waits, which is where nearly all the wall time is).
        pending = {key: items for key, items in buckets.items()}
        pool = self._drain_pool()
        prev_caps = {}  # bucket -> previous tier's caps (skip repeats)
        score_seen = {}  # bucket -> max final score observed this call
        for tier in (0, 1, 2, 3):
            if self.device_faults >= 2:
                break  # device unhealthy — finish on the host oracle
            # inflight items: (bucket_key, chunk, out) with out either a
            # finished result list or a Future resolving to one
            inflight = []
            counted = set()  # futures whose device fault is already tallied
            for (lq_c, lt_c), items in pending.items():
                if not items:
                    continue
                # caps follow the bucket's ACTUAL maxima, not the padded
                # class label (power-of-two classes inflate 50k to 64k,
                # and with it every score cap and memory bound)
                lq_max = max(len(p[0]) for _, p in items)
                lt_max = max(len(p[1]) for _, p in items)
                caps = self._tier_caps(lq_max, lt_max, tier,
                                       skey=(lq_c, lt_c))
                if caps.b_cap == 0 or (prev_caps.get((lq_c, lt_c)) == caps
                                       and self.device_faults == 0):
                    # not even one pair fits the device budget, or the
                    # ladder has nothing wider for this bucket (the
                    # global ladder tops out a tier early) — retrying
                    # identical caps cannot succeed, go to the fallback.
                    # (A device FAULT, by contrast, is retryable at the
                    # same caps — hence the fault-free gate.)
                    inflight.append(((lq_c, lt_c), items, [None] * len(items)))
                    continue
                prev_caps[(lq_c, lt_c)] = caps
                eng = self._engine(caps.k_win, caps.s_cap, caps.w_win)
                bs = min(self.cfg.batch_size, caps.b_cap)
                n_chunks = (len(items) + bs - 1) // bs
                probe = tier < 3 and n_chunks > 1
                # the probe (does this tier's cap ladder fit the
                # workload at all?) drains ASYNCHRONOUSLY: submission
                # keeps going while it computes (non-blocking done()
                # checks), so the common all-good case pays ZERO serial
                # stall; only past probe_hard chunks does an unresolved
                # probe block — a bad probe then only wastes the
                # already-submitted chunks
                probe_hard = min(8, n_chunks - 1)
                probe_fut = None
                skip_rest = False
                for ci in range(n_chunks):
                    chunk = items[ci * bs : (ci + 1) * bs]
                    if skip_rest or self.device_faults >= 2:
                        # probe said this tier's caps don't fit the
                        # workload (or the device died) — push on
                        inflight.append(
                            ((lq_c, lt_c), chunk, [None] * len(chunk)))
                        continue
                    # pack+upload+dispatch all run on submit workers
                    # (the native packer and the blocking upload both
                    # release the GIL, so workers parallelize cleanly and
                    # the main thread stays free to keep the queue
                    # full).  A queued batch only HOLDS its small
                    # input/output buffers between dispatch and drain:
                    # the device runs programs in order and allocates
                    # each program's temporaries at execution, so the
                    # byte gate reserves a buffer model (scaled to the
                    # actual chunk — tail/retry chunks are often far
                    # smaller than bs) and an in-flight COUNT cap bounds
                    # the queue.
                    cb = caps.batch_bytes * len(chunk) // bs
                    hold = min(cb, cb // 256 + (16 << 20))
                    self._inflight_sem().acquire()
                    self._mem_acquire(hold)
                    owned = False
                    try:
                        sub = self._submit_pool().submit(
                            eng.submit_batch, [p for _, p in chunk], None)
                        fut = pool.submit(self._drain_from, eng, sub, hold)
                        owned = True
                    finally:
                        if not owned:
                            self._mem_release(hold)
                            self._inflight_sem().release()
                    inflight.append(((lq_c, lt_c), chunk, fut))
                    if probe and ci == 0:
                        probe_fut = fut
                    if probe_fut is not None and (
                            probe_fut.done() or ci >= probe_hard):
                        try:
                            out = probe_fut.result()
                        except RuntimeError as exc:
                            # device fault (SURVEY §5): a failed device
                            # call raises a jax runtime error (a
                            # RuntimeError subclass); the chunk re-queues,
                            # and after repeated faults the remaining
                            # work finishes on the host oracle.  Host-side
                            # programming errors (TypeError/ValueError)
                            # propagate — silently rerouting them to the
                            # oracle would hide real bugs.
                            self._device_fault(exc)
                            counted.add(probe_fut)
                            probe_fut = None
                            continue
                        probe_fut = None
                        n_bad = sum(r is None for r in out)
                        skip_rest = n_bad * 10 >= len(out) * 9
            nxt = {key: [] for key in pending}
            for key, chunk, item in inflight:
                if isinstance(item, list):
                    out = item
                else:
                    try:
                        out = item.result()
                    except RuntimeError as exc:
                        if item not in counted:
                            self._device_fault(exc)
                        out = [None] * len(chunk)
                mx = score_seen.get(key, -1)
                for (idx, pair), res in zip(chunk, out):
                    if res is None:
                        nxt[key].append((idx, pair))
                    else:
                        results[idx] = res
                        if res.score > mx:
                            mx = res.score
                if mx >= 0:
                    score_seen[key] = mx
            pending = nxt
        for items in pending.values():  # final exact fallback
            for idx, (q, t) in items:
                results[idx] = self._oracle.align(q, t)
                self.oracle_pairs += 1
        # refresh the adaptive score-cap memory from this call's actual
        # score distribution (replace, not max-merge: a shift to easier
        # workloads must shrink the fitted caps again)
        for key, mx in score_seen.items():
            self._score_memory[key] = mx
        return results  # type: ignore[return-value]

    # -- threaded drain --------------------------------------------------------

    def _drain_pool(self):
        """Lazy worker pool that fetches and decodes finished batches.

        Each drain mostly waits on device->host copies (GIL released),
        with only a few ms of Python decode — so several workers overlap
        those waits without meaningful GIL contention.
        WFA_DRAIN_WORKERS overrides for hardware experiments."""
        pool = self._pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(
                max_workers=int(os.environ.get("WFA_DRAIN_WORKERS", "4")),
                thread_name_prefix="wfa-drain")
            self._pool = pool
        return pool

    def _submit_pool(self):
        """Lazy submit pool for pack+upload+dispatch (uploads block, so
        they get their own lane).

        THREE workers off-mesh: each runs a full pack+upload+dispatch
        (all GIL-releasing), so three overlap one another's blocking
        uploads.  Under a mesh ONE worker keeps the dispatch order
        deterministic (multi-process shard_map requires every process
        to enqueue the same programs in the same order)."""
        pool = self._spool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            n = (1 if self._mesh is not None
                 else int(os.environ.get("WFA_SUBMIT_WORKERS", "3")))
            pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="wfa-submit")
            self._spool = pool
        return pool

    def _inflight_sem(self):
        """Lazy in-flight batch COUNT cap: bounds how many batches may
        sit between dispatch and drain at once (the byte gate bounds
        their held buffers; this bounds runtime queue growth).
        WFA_MAX_INFLIGHT overrides for hardware experiments."""
        sem = self._isem
        if sem is None:
            import threading

            sem = threading.BoundedSemaphore(
                int(os.environ.get("WFA_MAX_INFLIGHT", "8")))
            self._isem = sem
        return sem

    @staticmethod
    def _drain_one(eng: BatchAligner, handle):
        """Worker-thread body: fetch a submitted batch and decode it."""
        return eng.finish_tokens(eng.finish_small(handle), fallback=False)

    def _drain_from(self, eng: BatchAligner, sub_fut, hold: int):
        """Drain a batch whose submit ran async: wait for the submit
        handle, then fetch + decode (submit-side device faults surface
        here and are handled exactly like drain-side ones).  Releases
        the batch's byte reservation and in-flight slot when its device
        buffers are deleted (or its submit/drain failed)."""
        try:
            return self._drain_one(eng, sub_fut.result())
        finally:
            self._mem_release(hold)
            self._inflight_sem().release()

    # -- in-flight device-memory gate ------------------------------------------

    def _mem_acquire(self, nbytes: int) -> None:
        """Block until `nbytes` more of modeled device memory fits the
        budget (at least one batch is always admitted)."""
        with self._mem_cv:
            while (self._mem_used > 0
                   and self._mem_used + nbytes > self.hbm_budget):
                self._mem_cv.wait()
            self._mem_used += nbytes

    def _mem_release(self, nbytes: int) -> None:
        with self._mem_cv:
            self._mem_used -= nbytes
            self._mem_cv.notify_all()

    def _device_fault(self, exc: Exception) -> None:
        """Record a device-side failure (runtime error, OOM, comms)."""
        import sys

        self.device_faults += 1
        print(f"wfa-tpu: device error ({exc}); "
              f"{'falling back to host oracle' if self.device_faults >= 2 else 'retrying'}",
              file=sys.stderr)

    def align_iter(
        self, pairs: Iterable[Tuple[bytes, bytes]], chunk: int = 4096
    ) -> Iterable[AlignmentResult]:
        """Streaming wrapper: buffers `chunk` pairs, aligns, yields in order."""
        buf: List[Tuple[bytes, bytes]] = []
        for pair in pairs:
            buf.append(pair)
            if len(buf) >= chunk:
                yield from self.align_all(buf)
                buf.clear()
        if buf:
            yield from self.align_all(buf)
