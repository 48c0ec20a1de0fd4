"""From the start of the process to the first timed step: loading, the
weights, the probe step, the engine with its plan and contingency
library, the warm-up steps, and on a cell's first run the kernels' build."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
