"""Core of the port: distributions, policies, coding, sweeps, planner,
tuner, and the replicated data-parallel mesh.

Analysis layer (numpy on the host, sweeps on a torch device):
    order_stats, policies, coding, simulator, spectrum, estimator, planner,
    tuner
Execution layer (``torch.distributed``):
    replication (the RDP mesh factoring and straggler-drop aggregation)

The package re-exports every public name of ``repro.core``, so code written
against the reference's ``core`` imports unchanged from this one.
"""

from .coding import (
    CODING_SCHEMES,
    CodingCandidate,
    MDSCode,
    PolynomialMatmulCode,
    chebyshev_nodes,
    expected_kofn_time,
)
from .gradient_coding import (
    CyclicGradientCode,
    compare_schemes,
    expected_coding_time,
    simulate_gradient_coding,
)
from .order_stats import (
    Empirical,
    Exponential,
    ServiceDistribution,
    ShiftedExponential,
    batch_service,
    completion_mean,
    completion_quantile,
    completion_var,
    expected_completion_rates,
    generalized_harmonic,
    harmonic,
)
from .policies import (
    Assignment,
    PolicyCandidate,
    ShedPolicy,
    SloClass,
    balanced_nonoverlapping,
    divisors,
    overlapping_cyclic,
    random_assignment,
    rate_aware_assignment,
    replica_major_nonoverlapping,
    unbalanced_nonoverlapping,
)
from .replication import (
    ReplicationPlan,
    aggregate_gradients,
    aggregate_host,
    batch_index_for_data_coord,
    make_rdp_mesh,
    rdp_data_spec,
)
from .simulator import (
    CodedSweepResult,
    FaultEvent,
    PolicySweepResult,
    ServingSimResult,
    ServingSweepResult,
    SimResult,
    SpeculativeSweepResult,
    StepTimeSimulator,
    SweepSimResult,
    censored_observations,
    completion_from_step_times,
    simulate_coverage,
    simulate_coverage_reference,
    simulate_maxmin,
    simulate_sojourn,
    simulate_sojourn_policies,
    simulate_sojourn_quantiles,
    simulate_sojourn_serving,
    sweep_coded,
    sweep_simulate,
    sweep_sojourn,
    sweep_sojourn_coded,
    sweep_sojourn_policies,
    sweep_sojourn_serving,
    sweep_sojourn_speculative,
)
from .spectrum import (
    METRICS,
    Metric,
    SpectrumPoint,
    SpectrumResult,
    continuous_optimum,
    metric_value,
    optimize,
    sweep,
    sweep_simulated,
)
from .estimator import (
    FitResult,
    GofResult,
    fit_best,
    fit_exponential,
    fit_shifted_exponential,
    goodness_of_fit,
    ks_critical,
    ks_statistic,
)
from .planner import (
    AnalyticPlanner,
    ClusterSpec,
    EmpiricalPlanner,
    HeterogeneousPlanner,
    Objective,
    Plan,
    Planner,
    SimulatedPlanner,
    make_planner,
)
from .tuner import RescalePlan, StragglerTuner, TunerConfig

__all__ = [k for k in dir() if not k.startswith("_")]
