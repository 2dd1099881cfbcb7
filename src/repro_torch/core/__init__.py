"""The paper's pipeline on PyTorch: hierarchical data-grid scheduling + HRS
replication and the discrete-event engine that evaluates them, with the
network engine's per-slot state, the batched planners, the batch brokers
and the replication economy running their kernels on the CUDA card."""

from .access import AccessHistory
from .catalog import FileInfo, ReplicaCatalog
from .economy import (DEFAULT_INTERVAL_S, ECON_BACKENDS, VALUE_MODELS,
                      EconomicValue, FileValue, PopularityValue,
                      ProposedReplication, ReplicationOptimizer)
from .metrics import ExperimentResult, run_experiment
from .network import NetworkEngine
from .replica import (BATCH_STRATEGIES, BHRStrategy, EconomicStrategy,
                      FetchPlan, HRSSinglePhaseStrategy, HRSStrategy,
                      LRUStrategy, NoReplicationStrategy, PredictiveStrategy,
                      ReplicaStrategy, StorageState, StorageTensorView,
                      STRATEGIES, STRATEGY_MODES, make_strategy)
from .scenarios import (ChurnSpec, SCENARIOS, SWEEPS, ScenarioSpec,
                        SweepSpec, arrival_schedule, get_scenario, get_sweep,
                        injections, register_scenario, register_sweep,
                        to_grid_config, with_axis)
from .scheduler import (DataAwareScheduler, Job, LeastLoadedScheduler,
                        RandomScheduler, SchedulerPolicy, SCHEDULERS,
                        ShortestTransferScheduler, make_scheduler)
from ..obs import OBS_MODES, TelemetryReport
from .simulator import GridSimulator, JobRecord, NETS, SimResult, TieRace
from .topology import GridTopology, Link, Region, Site
from .torchsched import (TorchLeastLoadedBroker, TorchRandomBroker,
                         TorchScheduler, TorchShortestTransferBroker,
                         leastloaded_select, select_site_vec,
                         select_sites_batch)
from .workload import (GB, MB, GridConfig, build_catalog, build_topology,
                       generate_jobs, job_type_filesets)

__all__ = [
    "AccessHistory", "FileInfo", "ReplicaCatalog", "DEFAULT_INTERVAL_S",
    "ECON_BACKENDS", "VALUE_MODELS", "EconomicValue", "FileValue",
    "PopularityValue", "ProposedReplication", "ReplicationOptimizer",
    "ExperimentResult", "run_experiment", "NetworkEngine",
    "BATCH_STRATEGIES", "BHRStrategy", "EconomicStrategy", "FetchPlan",
    "HRSSinglePhaseStrategy", "HRSStrategy", "LRUStrategy",
    "NoReplicationStrategy", "PredictiveStrategy", "ReplicaStrategy",
    "StorageState", "StorageTensorView", "STRATEGIES", "STRATEGY_MODES",
    "make_strategy",
    "ChurnSpec", "SCENARIOS", "SWEEPS", "ScenarioSpec", "SweepSpec",
    "arrival_schedule", "get_scenario", "get_sweep", "injections",
    "register_scenario", "register_sweep", "to_grid_config", "with_axis",
    "DataAwareScheduler", "Job", "LeastLoadedScheduler", "RandomScheduler",
    "SchedulerPolicy", "SCHEDULERS", "ShortestTransferScheduler",
    "make_scheduler", "GridSimulator", "JobRecord", "NETS", "OBS_MODES",
    "SimResult", "TelemetryReport", "TieRace", "GridTopology", "Link", "Region", "Site",
    "TorchLeastLoadedBroker", "TorchRandomBroker", "TorchScheduler",
    "TorchShortestTransferBroker", "leastloaded_select", "select_site_vec",
    "select_sites_batch", "GB", "MB", "GridConfig",
    "build_catalog", "build_topology", "generate_jobs", "job_type_filesets",
]
