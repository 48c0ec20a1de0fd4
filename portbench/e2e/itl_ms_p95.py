"""95th percentile of the gaps between consecutive output tokens of a
request, over every gap whose two tokens both fall in the window (a gap
that spans a churn tick includes the tick)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    t0 = run.window[0]
    gaps = [g for t, g in run.loop.gaps if run.in_window(t) and t - g > t0]
    return 1e3 * run.percentile(gaps, 95) if gaps else None
