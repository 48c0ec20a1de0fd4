"""DP relaxations the placement ran a churn tick in the window
(``PlanStats.dp_relaxes``: warm B1 solves of ``core/plan.py`` ``Plan``,
through ``SplitServeEngine.on_tick`` and the contingency refills)."""
LAYER = "placement"
UNIT = "count"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "itl_ms_p95"


def read(run):
    ticks = run.counters.get("ticks", 0)
    if not ticks or "dp_relaxes" not in run.counters:
        return None
    return run.counters["dp_relaxes"] / ticks
