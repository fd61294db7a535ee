"""Core of the port: distributions, policies, coding, sweeps, planner."""

from .coding import CodingCandidate, MDSCode, PolynomialMatmulCode
from .order_stats import Empirical, Exponential, ShiftedExponential
from .planner import (
    AnalyticPlanner,
    ClusterSpec,
    Objective,
    Plan,
    Planner,
    SimulatedPlanner,
    make_planner,
)
from .policies import PolicyCandidate, ShedPolicy, SloClass, divisors
from .simulator import (
    ServingSimResult,
    ServingSweepResult,
    simulate_sojourn_serving,
    sweep_coded,
    sweep_simulate,
    sweep_sojourn,
    sweep_sojourn_coded,
    sweep_sojourn_policies,
    sweep_sojourn_serving,
    sweep_sojourn_speculative,
)

__all__ = [
    "AnalyticPlanner",
    "ClusterSpec",
    "CodingCandidate",
    "Empirical",
    "Exponential",
    "MDSCode",
    "Objective",
    "Plan",
    "Planner",
    "PolicyCandidate",
    "ServingSimResult",
    "ServingSweepResult",
    "PolynomialMatmulCode",
    "ShedPolicy",
    "ShiftedExponential",
    "SimulatedPlanner",
    "SloClass",
    "divisors",
    "make_planner",
    "simulate_sojourn_serving",
    "sweep_coded",
    "sweep_simulate",
    "sweep_sojourn",
    "sweep_sojourn_coded",
    "sweep_sojourn_policies",
    "sweep_sojourn_serving",
    "sweep_sojourn_speculative",
]
