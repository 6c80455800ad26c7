"""Engagement metrics + significance tests for the A/B harness (the JAX
package's ``core/metrics.py``, copied bit for bit).

The paper reports "a statistically significant 0.47% lift in key user
engagement metrics". Our observable analogues:

  * slate CTR      — attributed watches / impressions (primary)
  * watches/user   — engagement volume
  * session hit    — sessions with >= 1 attributed watch

Arms are simulated under common random numbers (the simulator keys user
choice RNG by (user, day, session, round)), so the paired per-user delta is
the right unit: we report the paired bootstrap CI and a paired t-test on
per-user CTR, plus the pooled two-proportion z-test for reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ArmStats:
    name: str
    impressions: int = 0
    watches: int = 0
    # per-user tallies for paired tests
    user_impressions: np.ndarray = None
    user_watches: np.ndarray = None

    @property
    def ctr(self) -> float:
        return self.watches / max(self.impressions, 1)


def two_proportion_z(x1: int, n1: int, x2: int, n2: int) -> Tuple[float, float]:
    """Pooled two-proportion z-test. Returns (z, two-sided p)."""
    p1, p2 = x1 / max(n1, 1), x2 / max(n2, 1)
    p = (x1 + x2) / max(n1 + n2, 1)
    se = math.sqrt(max(p * (1 - p) * (1 / max(n1, 1) + 1 / max(n2, 1)), 1e-18))
    z = (p1 - p2) / se
    pval = 2 * (1 - _phi(abs(z)))
    return z, pval


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def paired_user_test(treat_w, treat_i, ctrl_w, ctrl_i,
                     n_boot: int = 2000, seed: int = 0) -> Dict[str, float]:
    """Paired per-user lift with bootstrap CI + t-test.

    Inputs are per-user watch and impression counts (same user index in both
    arms — common random numbers). Users with no impressions in either arm
    are dropped. Lift is the relative change of pooled CTR; the bootstrap
    resamples users.
    """
    mask = (treat_i > 0) & (ctrl_i > 0)
    tw, ti = treat_w[mask].astype(np.float64), treat_i[mask].astype(np.float64)
    cw, ci = ctrl_w[mask].astype(np.float64), ctrl_i[mask].astype(np.float64)
    n = mask.sum()
    ctr_t = tw.sum() / max(ti.sum(), 1)
    ctr_c = cw.sum() / max(ci.sum(), 1)
    lift = (ctr_t - ctr_c) / max(ctr_c, 1e-12)

    # paired t on per-user CTR deltas
    du = tw / np.maximum(ti, 1) - cw / np.maximum(ci, 1)
    t = du.mean() / max(du.std(ddof=1) / math.sqrt(max(n, 2)), 1e-18)
    p_t = 2 * (1 - _phi(abs(t)))  # normal approx (n is large)

    rng = np.random.RandomState(seed)
    boots = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.randint(0, n, n)
        bt = tw[idx].sum() / max(ti[idx].sum(), 1)
        bc = cw[idx].sum() / max(ci[idx].sum(), 1)
        boots[b] = (bt - bc) / max(bc, 1e-12)
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return {"lift": float(lift), "ctr_treat": float(ctr_t),
            "ctr_ctrl": float(ctr_c), "t": float(t), "p_t": float(p_t),
            "ci_lo": float(lo), "ci_hi": float(hi), "n_users": int(n),
            "significant": bool(p_t < 0.05 and (lo > 0) == (hi > 0))}


def summarize_arm(name: str, day_metrics: Sequence[Dict]) -> Dict[str, float]:
    imp = sum(m["impressions"] for m in day_metrics)
    w = sum(m["slate_watches"] for m in day_metrics)
    return {"arm": name, "impressions": imp, "watches": w,
            "ctr": w / max(imp, 1)}
