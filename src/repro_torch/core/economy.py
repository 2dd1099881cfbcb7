"""The replication economy's engine-facing constants.

The economy itself (``repro.core.economy``: the value models and the
``ReplicationOptimizer``, scored by the ``value_score`` kernel) is not
ported yet; the simulator raises when a run would arm it. These constants
are what the simulator and the scenario registry already need.
"""

from __future__ import annotations

#: Values the ``econ=`` engine flag accepts (the reference's).
ECON_BACKENDS = ("numpy", "pallas", "pallas-interpret")

#: Default period (seconds of sim time) between optimizer rounds when a
#: strategy enables the economy.
DEFAULT_INTERVAL_S = 900.0
