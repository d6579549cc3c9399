"""Host-side convergence analysis: plateau detection over per-chunk lex
cost series.

A copy of the JAX package's ``convergence`` module (standard library only).
The device half is ``ccx_torch.search.telemetry`` (the per-chunk tap rows
the chunked engines write); this half reads the decoded series.

* a **series** is a list of per-chunk lex cost vectors, in priority order;
* the **plateau chunk** of a series is the index of the last chunk whose
  vector lexicographically improved on the best seen so far (beyond the
  engines' own significance tolerance ``atol + rtol * |best|``); every
  later chunk was budget spent past convergence;
* the **wasted fraction** is (chunks after the plateau) / (chunks after
  the first). A chunk records the state at its end, so chunk 0 is never
  wasted.
"""

from __future__ import annotations

#: significance tolerance for IMPROVEMENT, mirroring the engines'
#: ``goal_tols`` (a change smaller than this never flipped an acceptance
#: either)
RTOL = 1e-6
ATOL = 1e-6
#: coarser tolerance for REGRESSION: the descent engines accept
#: sub-tolerance upward drift in a high tier while a lower tier improves
#: (the batch-composition rule filters per move, and f32 accumulation
#: compounds over a 50-iteration chunk — measured at B5 lean:
#: PotentialNwOut +0.0003 on 250.21, +1.2e-6 relative, while NwOut fell
#: 98 → 65 in the same chunk). A symmetric tolerance would read that
#: chunk as "stopped improving" and the advisor would propose cutting a
#: budget that was buying real quality, so an upward change only blocks
#: improvement when it is significant at this coarser scale; anything
#: smaller reads as "equal" and the walk continues to lower tiers.
UP_RTOL = 1e-4
UP_ATOL = 1e-3

#: advisory past-plateau threshold: a run spending more than this share of
#: its chunks past plateau is flagged (a warning, never a failure)
WASTE_WARN = 0.30


def lex_improved(vec, best, rtol: float = RTOL, atol: float = ATOL,
                 up_rtol: float = UP_RTOL, up_atol: float = UP_ATOL) -> bool:
    """True when ``vec`` is lexicographically significantly below ``best``:
    walking tiers in priority order, the first decisively-changed goal
    moved down (asymmetric tolerances — see UP_RTOL above)."""
    for v, b in zip(vec, best):
        if v < b - (atol + rtol * abs(b)):
            return True
        if v > b + (up_atol + up_rtol * abs(b)):
            return False
    return False


def plateau_chunk(series) -> int:
    """Index of the last chunk whose lex vector improved on the running
    best (0 for an empty/single-chunk/never-improving series).

    Scalar series (plain energies, e.g. the flight recorder's tier-0
    heartbeat energies) are accepted too — each value is treated as a
    one-goal vector."""
    last = 0
    best = None
    for i, vec in enumerate(series):
        row = vec if isinstance(vec, (list, tuple)) else (vec,)
        if best is None:
            best = list(row)
            continue
        if lex_improved(row, best):
            best = list(row)
            last = i
    return last


def wasted_fraction(series) -> float:
    """Share of the series' chunks spent past the plateau (0.0..1.0)."""
    n = len(series)
    if n <= 1:
        return 0.0
    return (n - 1 - plateau_chunk(series)) / (n - 1)


def segment_stats(seg: dict) -> dict | None:
    """Plateau stats for ONE telemetry segment (the dict
    ``ccx_torch.search.telemetry.decode`` emits: ``series`` + optional
    ``chunk``/``budget``/``truncated``). None when the segment carries no
    usable series."""
    series = seg.get("series") or []
    if not series:
        return None
    plateau = plateau_chunk(series)
    n = len(series)
    out = {
        "chunks": n,
        "plateauChunk": plateau,
        "wastedFraction": round(wasted_fraction(series), 4),
        "truncated": bool(seg.get("truncated")),
    }
    chunk = seg.get("chunk")
    budget = seg.get("budget")
    if chunk:
        out["chunkSize"] = int(chunk)
        # budget units (SA steps / descent iterations) covered through the
        # plateau chunk's END — the floor any retune must keep
        out["plateauBudget"] = int((plateau + 1) * chunk)
    if budget is not None:
        out["budget"] = int(budget)
    return out


def propose_budget(seg: dict, margin: float = 1.25) -> int | None:
    """Retuned per-phase budget proposal: the budget units spent through
    the plateau chunk, plus a safety margin, capped at the configured
    budget (never propose MORE than was configured) and floored at one
    chunk. None when the segment lacks chunk sizing.

    A truncated segment (more chunks ran than the ring buffer holds) only
    proves the plateau is AT OR AFTER the last retained early row — the
    proposal is then the configured budget itself (no evidence to shrink
    on)."""
    st = segment_stats(seg)
    if st is None or "chunkSize" not in st:
        return None
    budget = st.get("budget")
    if st["truncated"]:
        return budget
    proposed = int(st["plateauBudget"] * margin)
    chunk = st["chunkSize"]
    proposed = max(proposed, chunk)
    if budget is not None:
        proposed = min(proposed, budget)
    return proposed


def phase_table(convergence: dict) -> list[dict]:
    """Flatten an ``OptimizerResult.convergence`` block into per-phase
    advisor rows (last segment per phase — the converged run; earlier
    segments of a multi-run phase, e.g. repair-round re-polishes, are
    summed into the wasted totals but not re-proposed)."""
    rows: list[dict] = []
    for phase, segs in (convergence.get("phases") or {}).items():
        segs = [s for s in segs if s.get("series")]
        if not segs:
            continue
        last = segs[-1]
        st = segment_stats(last) or {}
        total_chunks = sum(len(s["series"]) for s in segs)
        # truncated segments carry a GAPPY ring (opening rows + the
        # latest chunk): the retained rows say nothing about where the
        # missing middle plateaued, so — like propose_budget — they
        # contribute no waste evidence
        full = [s for s in segs if not s.get("truncated")]
        past = sum(
            max(len(s["series"]) - 1 - plateau_chunk(s["series"]), 0)
            for s in full
        )
        steppable = sum(max(len(s["series"]) - 1, 0) for s in full)
        rows.append({
            "phase": phase,
            "segments": len(segs),
            "chunks": total_chunks,
            "plateauChunk": st.get("plateauChunk"),
            "wastedFraction": (
                round(past / steppable, 4) if steppable else 0.0
            ),
            "chunkSize": st.get("chunkSize"),
            "budget": st.get("budget"),
            "proposedBudget": propose_budget(last),
            "truncated": st.get("truncated", False),
        })
    rows.sort(key=lambda r: -(r["wastedFraction"] or 0.0))
    return rows


def ladder_summary(seg: dict) -> dict | None:
    """Replica-exchange ladder roll-up for ONE telemetry segment: total/accepted exchange pairs, the overall acceptance rate, and
    the ladder geometry the annealer attached (``nTemps``, ``interval``,
    ``rungSize``, ``endTemps``). None for flat segments — no ``exchange``
    series or nothing attempted — so every consumer can print it
    conditionally without schema checks.

    Exchange-acceptance rate is the classic ladder-health gauge: near 0
    the rungs are too far apart to communicate (the ladder degenerates to
    independent restarts), near 1 they are so close the exchange buys no
    mixing; the 20-40% band is the usual target. The report prints it per
    phase so a campaign retune can tune ``n_temps`` from evidence."""
    ex = seg.get("exchange") or {}
    attempted = ex.get("attempted") or []
    total_att = sum(int(a) for a in attempted)
    if total_att <= 0:
        return None
    accepted = ex.get("accepted") or []
    total_acc = sum(int(a) for a in accepted)
    out = {
        "attempted": total_att,
        "accepted": total_acc,
        "acceptRate": round(total_acc / total_att, 4),
        "sweeps": sum(1 for a in attempted if int(a) > 0),
    }
    ladder = seg.get("ladder") or {}
    for k in ("nTemps", "interval", "rungSize", "t0", "endTemps"):
        if k in ladder:
            out[k] = ladder[k]
    return out


def total_wasted_fraction(convergence: dict) -> float:
    """Whole-run share of chunk budget past plateau, across every phase
    and segment — the single number a >WASTE_WARN warning reads.
    Truncated segments are skipped (the ring kept only the opening rows +
    the latest chunk — no evidence of where the middle plateaued),
    matching ``propose_budget``'s never-shrink-on-truncation rule."""
    past = steppable = 0
    for segs in (convergence.get("phases") or {}).values():
        for s in segs:
            series = s.get("series") or []
            if len(series) <= 1 or s.get("truncated"):
                continue
            steppable += len(series) - 1
            past += len(series) - 1 - plateau_chunk(series)
    return past / steppable if steppable else 0.0
