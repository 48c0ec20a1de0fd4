"""Runtime of the port: the split-serving engine."""
