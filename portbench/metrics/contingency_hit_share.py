"""The share of the window's failovers and recoveries that the contingency
library served (``EngineStats.contingency_hits`` over hits and misses)."""
LAYER = "placement"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "itl_ms_p95"


def read(run):
    c = run.counters
    n = c.get("contingency_hits", 0) + c.get("contingency_misses", 0)
    if not n:
        return None
    return 100.0 * c["contingency_hits"] / n
