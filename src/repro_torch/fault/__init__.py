"""Fault injection for the grid simulator (the grid half of
``repro.fault``): deterministic site-churn schedules."""

from .failures import churn_schedule

__all__ = ["churn_schedule"]
