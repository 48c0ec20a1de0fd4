"""95th percentile, over every churn tick in the window, of the time from
the tick's arrival to the return of ``on_tick``, when the new placement is
in force (host clock).  A per-layer metric: its spread between runs is
wider than an end-to-end bound may be, since the percentile falls among
the few ticks that re-split."""
LAYER = "placement"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "itl_ms_p95"


def read(run):
    xs = [k.t1 - k.t0 for k in run.window_ticks()]
    return 1e3 * run.percentile(xs, 95) if xs else None
