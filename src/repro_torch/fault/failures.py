"""Site churn for the grid simulator.

The grid half of ``repro.fault.failures``: :func:`churn_schedule` expands
a :class:`~repro_torch.core.scenarios.ChurnSpec` into deterministic site
failure/recovery events for the discrete-event simulator. The scenario
engine (:func:`repro_torch.core.scenarios.injections`) drives it to build
the site-churn regimes.
"""

from __future__ import annotations

import random as _random
from typing import TYPE_CHECKING

if TYPE_CHECKING:                      # the spec's module imports this one
    from ..core.scenarios import ChurnSpec


def churn_schedule(spec: "ChurnSpec", n_sites: int,
                   seed: int = 0) -> list[tuple[int, float, float]]:
    """Expand a :class:`ChurnSpec` into ``(site, at, duration)`` tuples for
    :func:`repro_torch.core.run_experiment`'s ``failures`` argument.

    Failure times are evenly spaced over the window with a small jittered
    offset; sites are drawn without replacement until the pool is exhausted
    (then with replacement), so short schedules never hit one site twice.
    """
    if spec.n_failures <= 0:
        return []
    rng = _random.Random(seed ^ 0x5EED)
    start, end = spec.window
    span = max(0.0, end - start)
    pool = list(range(n_sites))
    rng.shuffle(pool)
    out = []
    for i in range(spec.n_failures):
        site = pool[i] if i < len(pool) else rng.randrange(n_sites)
        frac = (i + rng.random()) / spec.n_failures
        at = start + frac * span
        duration = rng.expovariate(1.0 / spec.mean_downtime_s)
        out.append((site, at, max(1.0, duration)))
    return out
