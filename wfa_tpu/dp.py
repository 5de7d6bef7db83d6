"""Independent gap-affine DP oracle for score cross-checks.

A classic O(n·m) Gotoh dynamic program, written independently of the
wavefront recurrences, used by the property tests to validate that the
WFA engines (oracle and device) return the optimal gap-affine score.

Global here also means the reference's flavor: the alignment always
*starts* with a match/mismatch consuming (q[0], t[0]) — the reference
seeds M[0|x][k=0] with offset 1 (wfa.go:155-160) and has no I/D seeds, so
a global path can never begin with a gap (e.g. q="G" vs t="C" costs x,
never 2·(o+e), even when the latter is smaller).

Semi-global here means the reference's flavor:

* the alignment *starts* with a match/mismatch consuming q[0] against any
  t[k], or q[k] against t[0] (the seeding of wfa.go:155-183);
* it *ends* at a cell (v, h) with (v == n and h >= n) or
  (h == m and v >= m) — the end-finder's eligibility test (wfa.go:319,354).

Scores only — CIGAR tie-breaking is the wavefront engines' concern.
"""

from __future__ import annotations

import numpy as np

from .constants import Penalties

_INF = np.int64(1 << 40)


def dp_score(
    q: bytes,
    t: bytes,
    penalties: Penalties = Penalties(),
    global_alignment: bool = True,
) -> int:
    """Minimal gap-affine alignment score of q vs t."""
    n, m = len(q), len(t)
    x = penalties.mismatch
    o = penalties.gap_open
    e = penalties.gap_ext

    qa = np.frombuffer(q, dtype=np.uint8).astype(np.int64)
    ta = np.frombuffer(t, dtype=np.uint8).astype(np.int64)

    # M[i, j]: q[:i] vs t[:j] ending in match/mismatch;
    # I[i, j]: ending in a gap consuming target; D[i, j]: consuming query.
    M = np.full((n + 1, m + 1), _INF, dtype=np.int64)
    I = np.full((n + 1, m + 1), _INF, dtype=np.int64)
    D = np.full((n + 1, m + 1), _INF, dtype=np.int64)

    if global_alignment:
        # the reference's global paths start with M/X at (1,1) — no free
        # leading gap states (wfa.go:155-160), hence no I/D border inits.
        M[0, 0] = 0

    for i in range(1, n + 1):
        sub = np.where(ta == qa[i - 1], 0, x)  # cost vs t[j-1], shape [m]
        prev = np.minimum(np.minimum(M[i - 1], I[i - 1]), D[i - 1])
        # D (consumes query) depends only on row i-1 — vectorizable.
        D[i, 1:] = np.minimum(prev[1:] + o + e, D[i - 1, 1:] + e)
        Mi = M[i]
        Ii = I[i]
        Di = D[i]
        for j in range(1, m + 1):
            Mi[j] = prev[j - 1] + sub[j - 1]
            if not global_alignment and (i == 1 or j == 1):
                # fresh semi-global start: first consumed pair is (i, j)
                Mi[j] = min(Mi[j], sub[j - 1])
            # I (consumes target) is a row-wise scan — sequential in j.
            Ii[j] = min(min(Mi[j - 1], Di[j - 1], Ii[j - 1]) + o + e,
                        Ii[j - 1] + e)

    if global_alignment:
        return int(min(M[n, m], I[n, m], D[n, m]))

    # semi-global: min over eligible end cells.  Gap states are reachable
    # ends in the reference too (their values are copied into the M
    # component by next(); wfa.go:655).
    best = int(_INF)
    allmin = np.minimum(np.minimum(M, I), D)
    for h in range(n, m + 1):  # last row v == n, h >= n
        best = min(best, int(allmin[n, h]))
    for v in range(m, n + 1):  # last column h == m, v >= m
        best = min(best, int(allmin[v, m]))
    return best
