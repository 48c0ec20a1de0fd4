"""Tokens emitted to requests (at any exit) over the window's wall time."""
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    n = sum(1 for t in run.loop.token_t if run.in_window(t))
    return n / run.window_s
