"""Fault injection: deterministic site-churn schedules for the grid
simulator, and checkpoint/restart supervision of the training runtime."""

from .failures import (FailurePlan, SimulatedFailure, SupervisorStats,
                       TrainingSupervisor, churn_schedule)

__all__ = ["FailurePlan", "SimulatedFailure", "SupervisorStats",
           "TrainingSupervisor", "churn_schedule"]
