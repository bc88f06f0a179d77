"""Batched device solver: planner, fused level kernel, batch solver."""

from .planner import Plan, PlanError, plan_circuit
from .batch_solver import FAIL_NONE, BatchResult, BatchSolver

__all__ = ["Plan", "PlanError", "plan_circuit", "BatchResult", "BatchSolver", "FAIL_NONE"]
