"""Core of the port: FIN placement of early-exit DNNs on PyTorch / CUDA.

  system_model   -- tiers / nodes / per-app slices (Plane 1), host objects
  dnn_profile    -- block/exit profiles (Plane 2), paper Tables II-IV
  problem        -- configuration evaluation against (3a)-(3e), host code
  extended_graph -- Eq. (1)-(2) weights as device tensors
  feasible_graph -- gamma-replicated FIN feasibility graph (Eq. 4 + pruning)
  bellman_ford   -- the banded (min,+) relaxations (CUDA kernels on the card)
  fin / mcp / optimum -- the three solvers compared in Sec. V
  frontier       -- the Pareto frontier behind the FIN argmin (host code)
  plan           -- the persistent plan IR: typed deltas, warm re-solves
  population     -- struct-of-arrays cohorts: whole-population churn ticks
  scenarios      -- the paper's evaluation scenarios and churn traces
  contingency    -- precomputed-failover library (O(1) failure masks)
  multiapp       -- Sec. V multi-application orchestration
  capacity       -- population-shared node/link capacity + congestion pricing
  online         -- the churn orchestrator over plans or cohorts
  faults         -- deterministic fault injection (crashes, stalls, corrupt
                    telemetry); its names stay at ``core.faults``
"""
from .capacity import (CongestionController, CongestionReport,
                       SharedCapacity, accumulate_loads, config_load_rows)
from .contingency import (ContingencyEntry, ContingencyLibrary,
                          ContingencyPolicy, ContingencyStats,
                          NoFeasiblePlacement, PopulationContingency,
                          candidate_masks, tier_groups_of)
from .dnn_profile import (BITS_PER_FEATURE, DNNProfile, ExitSpec,
                          all_paper_apps, paper_profile, synthetic_profile)
from .extended_graph import (ExtendedGraph, build_extended_graph,
                             build_extended_graphs, to_networkx)
from .feasible_graph import (FeasibleGraph, build_feasible_graph,
                             build_feasible_graphs)
from .fin import fin_all_exit_costs, solve_fin, solve_many
from .frontier import (FrontierRow, ParetoFrontier, brute_force_frontier,
                       frontier_from_rows, pareto_mask)
from .mcp import solve_mcp
from .multiapp import (PAPER_MULTIAPP_REQS, AppStats, MultiAppResult,
                       PlanCache, app_price_weights, default_solvers,
                       run_multiapp, user_network, user_networks)
from .online import (ChurnOrchestrator, ChurnStats, TickReport,
                     population_cohorts, population_plans)
from .optimum import solve_opt
from .plan import (Plan, PlanStats, migration_delta, solve_plans,
                   update_uplinks)
from .population import Population, PopulationStats
from .problem import (AppRequirements, Config, ConfigEval, Solution,
                      evaluate_config)
from .scenarios import (ChurnEvent, churn_trace, paper_apps, paper_scenario,
                        sweep_scenarios)
from .system_model import (PAPER_TIERS, TPU_TIERS, Network, NodeSpec,
                           make_network, make_node)

__all__ = [
    "NodeSpec", "Network", "make_node", "make_network", "PAPER_TIERS",
    "TPU_TIERS", "DNNProfile", "ExitSpec", "paper_profile", "all_paper_apps",
    "synthetic_profile", "BITS_PER_FEATURE", "AppRequirements", "Config",
    "ConfigEval", "Solution", "evaluate_config", "ExtendedGraph",
    "build_extended_graph", "build_extended_graphs", "to_networkx",
    "FeasibleGraph", "build_feasible_graph", "build_feasible_graphs",
    "solve_fin", "solve_many", "fin_all_exit_costs",
    "FrontierRow", "ParetoFrontier", "brute_force_frontier",
    "frontier_from_rows", "pareto_mask",
    "Plan", "PlanStats", "solve_plans", "update_uplinks", "migration_delta",
    "solve_mcp",
    "solve_opt", "run_multiapp", "MultiAppResult", "AppStats",
    "PAPER_MULTIAPP_REQS", "default_solvers", "user_network",
    "user_networks", "PlanCache",
    "ChurnEvent", "churn_trace", "ChurnOrchestrator", "ChurnStats",
    "TickReport", "population_plans", "population_cohorts",
    "Population", "PopulationStats",
    "SharedCapacity", "CongestionController", "CongestionReport",
    "accumulate_loads", "config_load_rows", "app_price_weights",
    "ContingencyEntry", "ContingencyLibrary", "ContingencyPolicy",
    "ContingencyStats", "NoFeasiblePlacement", "PopulationContingency",
    "candidate_masks", "tier_groups_of",
    "paper_apps", "paper_scenario", "sweep_scenarios",
]
