"""95th percentile, over every request whose first token falls in the
window, of the time from its submission to that token (prompts are
consumed one token a step, as the engine does)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    xs = [i.t_first - i.t_submit for i in run.loop.infos
          if i.t_first is not None and run.in_window(i.t_first)]
    return 1e3 * run.percentile(xs, 95) if xs else None
