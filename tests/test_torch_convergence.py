"""The port's copy of the convergence analysis against the JAX package's.

Every function of ``ccx_torch.common.convergence`` gets the same seeded
series (and telemetry segments built from them) as
``ccx.common.convergence`` and must return the same value.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.common import convergence as jconv
from ccx_torch.common import convergence as tconv


def _series(seed: int, n: int, g: int) -> list[list[float]]:
    """A noisy, mostly descending lex series with plateaus and ties."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(0, 3, size=(n, g)), axis=0)[::-1].astype(float)
    base += rng.choice([0.0, 1e-7, 5e-4, 0.02], size=(n, g))
    return base.round(7).tolist()


def _segment(seed: int, n: int, truncated: bool = False, exchange: bool = False) -> dict:
    rng = np.random.default_rng(seed + 100)
    seg = {"series": _series(seed, n, 3), "chunk": 25, "budget": 25 * n + 5,
           "truncated": truncated}
    if exchange:
        att = rng.integers(0, 5, size=n).tolist()
        seg["exchange"] = {"attempted": att,
                           "accepted": [int(rng.integers(0, a + 1)) for a in att]}
        seg["ladder"] = {"nTemps": 4, "interval": 1, "rungSize": 4, "t0": 0.3,
                         "endTemps": [1e-4, 1e-3, 1e-2, 0.3]}
    return seg


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_series_functions_equal_jax(seed):
    s = _series(seed, 12, 4)
    assert tconv.plateau_chunk(s) == jconv.plateau_chunk(s)
    assert tconv.wasted_fraction(s) == jconv.wasted_fraction(s)
    scalars = [row[0] for row in s]
    assert tconv.plateau_chunk(scalars) == jconv.plateau_chunk(scalars)
    for a, b in zip(s, s[1:]):
        for kw in ({}, {"rtol": 0.0, "atol": 0.5}):
            assert tconv.lex_improved(a, b, **kw) == jconv.lex_improved(a, b, **kw)
            assert tconv.lex_improved(b, a, **kw) == jconv.lex_improved(b, a, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_functions_equal_jax(seed):
    segs = [_segment(seed, 9), _segment(seed + 1, 5, truncated=seed % 2 == 0),
            _segment(seed + 2, 7, exchange=True), {"series": []}]
    for seg in segs:
        assert tconv.segment_stats(seg) == jconv.segment_stats(seg)
        assert tconv.propose_budget(seg) == jconv.propose_budget(seg)
        assert tconv.propose_budget(seg, margin=1.5) == jconv.propose_budget(seg, margin=1.5)
        assert tconv.ladder_summary(seg) == jconv.ladder_summary(seg)
    conv = {"goals": ["a", "b", "c"], "phases": {"anneal": segs[:2], "polish": segs[2:]}}
    assert tconv.phase_table(conv) == jconv.phase_table(conv)
    assert tconv.total_wasted_fraction(conv) == jconv.total_wasted_fraction(conv)


def test_constants_equal_jax():
    for name in ("RTOL", "ATOL", "UP_RTOL", "UP_ATOL", "WASTE_WARN"):
        assert getattr(tconv, name) == getattr(jconv, name), name
