"""Minimax coefficient schedules for the Newton-Schulz polar iteration.

The MTIP data projection computes the unitary polar factor of the per-order
matrices B_l each iteration (reference fxs_Projections.py:752-790 uses an
exact SVD; the rebuild's matmul-only Newton-Schulz is batched GEMMs —
projections.polar_unitary_newton_schulz). With the FIXED quintic
coefficients (3.4445, -4.7750, 2.0315) every step multiplies small singular
values by ~3.44, so reaching sigma ~ 1 from a conservative sigma_min = 1e-7
costs 16 quintic + 4 cubic steps = 56 matmul-units per matrix — at the
production scale (N_q = 256, L = 127) the data projection it dominates is
160.9 GFLOP of the 738 GFLOP iteration, the largest single block.

This module computes a PER-STEP minimax-optimal schedule instead: at each
step, over the current singular-value interval [lo, hi], pick the odd
quintic p(x) = a x + b x^3 + c x^5 minimizing max |1 - p(x)| (a linear
program over a dense grid — a 3-parameter Chebyshev/Remez problem), then
advance the interval to [min p, max p]. Greedy per-step minimax is the
optimal composition for this family (each step's error interval is the next
step's domain, and the minimax polynomial is monotone-optimal on it); the
same construction drives the "Polar Express" GPU orthogonalizers used for
Muon-style optimizers. From sigma_min = 1e-7 the schedule reaches
max |1 - sigma| < 1e-6 in 14 quintic steps (10 without the finite-precision
margin band below, which buys f32 robustness for 4 extra steps) —
42 matmul-units vs the fixed scheme's 16x3 + 4x2 = 56, a 1.33x arithmetic
cut at IDENTICAL (slightly better, in the f32 sense) accuracy:
the fixed-coefficient iteration oscillates in a +-0.3 band before its
cubic polish, while every schedule step here is the interval-optimal
contraction.

Safety: |1 - p| <= t < 1 on [lo, hi] guarantees p > 0 — singular values
can never cross zero, so the polar factor's sign structure is preserved
(same argument as for the fixed scheme). Values BELOW the assumed lo only
converge slower (p(x) ~= a x near 0, a > 1); they cannot diverge, because
each p is bounded by 1 + t on [0, hi] (odd quintics take their interval
maximum inside [0, hi]).

Pure-host, numpy/scipy only; schedules are computed once per
(sigma_min, target) and cached — they are a handful of floats baked into
the jitted iteration as Python constants.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def _minimax_quintic(lo: float, hi: float, grid: int = 4001):
    """Coefficients (a, b, c) of the odd quintic minimizing
    max_{x in [lo, hi]} |1 - (a x + b x^3 + c x^5)|, via LP on a dense grid.

    Returns (a, b, c, t) with t the attained minimax error. The LP is
    solved in the scaled variable y = x / hi (conditioning: hi^5 spans
    ~35 orders of magnitude over a schedule), then rescaled.
    """
    from scipy.optimize import linprog

    y = np.linspace(lo / hi, 1.0, grid)
    V = np.stack([y, y ** 3, y ** 5], axis=1)
    # minimize t  s.t.  -t <= 1 - V@coef <= t
    #   ->  V@coef + t >= 1   and   V@coef - t <= 1
    A_ub = np.block([[-V, -np.ones((grid, 1))],
                     [V, -np.ones((grid, 1))]])
    b_ub = np.concatenate([-np.ones(grid), np.ones(grid)])
    c_obj = np.array([0.0, 0.0, 0.0, 1.0])
    res = linprog(c_obj, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * 3 + [(0, None)],
                  method="highs")
    if not res.success:       # pragma: no cover - highs is deterministic
        raise RuntimeError(f"minimax LP failed on [{lo}, {hi}]: {res.message}")
    a, b, c = res.x[:3]
    return (float(a / hi), float(b / hi ** 3), float(c / hi ** 5),
            float(res.x[3]))


@lru_cache(maxsize=None)
def polar_express_schedule(sigma_min: float = 1e-7, target: float = 1e-6,
                           max_steps: int = 24, margin: float = 0.02):
    """Greedy minimax quintic schedule [(a, b, c), ...] mapping singular
    values in [sigma_min, 1] to within `target` of 1.

    The caller must normalize the input matrix by an UPPER bound of its
    spectral norm (as polar_unitary_newton_schulz already does); sigma_min
    is the assumed lower bound relative to that normalization — 1e-7 is
    conservative for f32 data (values below it still converge, just beyond
    the pinned target).

    `margin` is the finite-precision safety band: each step's polynomial is
    optimized (and its image interval tracked) over [lo, hi*(1+margin)]
    rather than [lo, hi]. The pure minimax polynomial has a steep slope at
    the interval's top edge (p'(hi) > 10 in the growth phase), so an f32
    rounding perturbation pushing a singular value just above hi would be
    AMPLIFIED each step — measured divergence by step ~7 in complex64
    without the band. With the band, values up to hi*(1+margin) remain in
    the controlled region; per-step f32 matmul noise (~1e-5 relative at
    n = 255) is orders below the 2% band.
    """
    lo, hi = float(sigma_min), 1.0
    sched = []
    for _ in range(max_steps):
        a, b, c, _t = _minimax_quintic(lo, hi * (1.0 + margin))
        # evaluate the attained interval exactly on a fine grid over the
        # WIDENED domain (the LP's t is a grid approximation; p can peak
        # between grid points, so re-measure on the continuous interval)
        x = np.linspace(lo, hi * (1.0 + margin), 20001)
        p = a * x + b * x ** 3 + c * x ** 5
        lo, hi = float(p.min()), float(p.max())
        sched.append((float(a), float(b), float(c)))
        if max(abs(1.0 - lo), abs(hi - 1.0)) < target:
            break
    else:                     # pragma: no cover - 24 steps always suffice
        raise RuntimeError(
            f"schedule did not converge from sigma_min={sigma_min}")
    return tuple(sched)


# The default schedule (sigma_min = 1e-7, target = 1e-6, margin = 0.02),
# baked as a literal so production setup does not pay the ~8 s LP solve.
# tests/test_polar_schedule.py asserts this literal matches the generator.
DEFAULT_SCHEDULE = (
    (8.3473509604470308, -23.823541976554029, 16.998243482319499),
    (4.1736710381989175, -2.9779406568262012, 0.53119511093287242),
    (4.1736505861882556, -2.9779272529311722, 0.53119369407648187),
    (4.1735651103018396, -2.9778711109047031, 0.53118772425811456),
    (4.1732082272683311, -2.9776363981659353, 0.53116268307573211),
    (4.1717196201396032, -2.9766573046212752, 0.53105822116741475),
    (4.1655215821064022, -2.9725796720622202, 0.53062317626592592),
    (4.1398988109007648, -2.9557049392215768, 0.5288228027645826),
    (4.0370935219759208, -2.8877195330642076, 0.52157325781157493),
    (3.6704342986757559, -2.6412034958889161, 0.49535767455635554),
    (2.7937069762789752, -2.0153751781889429, 0.42983058907334448),
    (1.9962693187381422, -1.3509579013524158, 0.36563451104163619),
    (1.8575159970392476, -1.2139399664162491, 0.35645176252774696),
    (1.8565202504357181, -1.2133131895874749, 0.35679235576442675),
)


def default_or_computed_schedule(sigma_min: float = 1e-7,
                                 target: float = 1e-6):
    """The baked DEFAULT_SCHEDULE for the default parameters, else the LP
    generator (cached per process)."""
    if (abs(sigma_min - 1e-7) < 1e-12 and abs(target - 1e-6) < 1e-12):
        return DEFAULT_SCHEDULE
    return polar_express_schedule(sigma_min, target)


def apply_schedule_numpy(X, schedule):
    """Reference (host) application of a schedule — for tests."""
    for a, b, c in schedule:
        X2 = X.conj().swapaxes(-1, -2) @ X
        X = a * X + X @ (b * X2 + c * (X2 @ X2))
    return X
