"""The paper's pipeline on PyTorch: hierarchical data-grid scheduling + HRS
replication and the discrete-event engine that evaluates them, with the
network engine's per-slot state and re-rates on the CUDA card."""

from .access import AccessHistory
from .catalog import FileInfo, ReplicaCatalog
from .economy import DEFAULT_INTERVAL_S, ECON_BACKENDS
from .metrics import ExperimentResult, run_experiment
from .network import NetworkEngine
from .replica import (BHRStrategy, FetchPlan, HRSSinglePhaseStrategy,
                      HRSStrategy, LRUStrategy, NoReplicationStrategy,
                      ReplicaStrategy, StorageState, STRATEGIES,
                      STRATEGY_MODES, make_strategy)
from .scenarios import (ChurnSpec, SCENARIOS, SWEEPS, ScenarioSpec,
                        SweepSpec, arrival_schedule, get_scenario, get_sweep,
                        injections, register_scenario, register_sweep,
                        to_grid_config, with_axis)
from .scheduler import (DataAwareScheduler, Job, LeastLoadedScheduler,
                        RandomScheduler, SchedulerPolicy, SCHEDULERS,
                        ShortestTransferScheduler, make_scheduler)
from .simulator import GridSimulator, JobRecord, NETS, OBS_MODES, SimResult
from .topology import GridTopology, Link, Region, Site
from .torchsched import TorchScheduler, select_site_vec, select_sites_batch
from .workload import (GB, MB, GridConfig, build_catalog, build_topology,
                       generate_jobs, job_type_filesets)

__all__ = [
    "AccessHistory", "FileInfo", "ReplicaCatalog", "DEFAULT_INTERVAL_S",
    "ECON_BACKENDS", "ExperimentResult", "run_experiment", "NetworkEngine",
    "BHRStrategy", "FetchPlan", "HRSSinglePhaseStrategy", "HRSStrategy",
    "LRUStrategy", "NoReplicationStrategy", "ReplicaStrategy",
    "StorageState", "STRATEGIES", "STRATEGY_MODES", "make_strategy",
    "ChurnSpec", "SCENARIOS", "SWEEPS", "ScenarioSpec", "SweepSpec",
    "arrival_schedule", "get_scenario", "get_sweep", "injections",
    "register_scenario", "register_sweep", "to_grid_config", "with_axis",
    "DataAwareScheduler", "Job", "LeastLoadedScheduler", "RandomScheduler",
    "SchedulerPolicy", "SCHEDULERS", "ShortestTransferScheduler",
    "make_scheduler", "GridSimulator", "JobRecord", "NETS", "OBS_MODES",
    "SimResult", "GridTopology", "Link", "Region", "Site", "TorchScheduler",
    "select_site_vec", "select_sites_batch", "GB", "MB", "GridConfig",
    "build_catalog", "build_topology", "generate_jobs", "job_type_filesets",
]
