"""Runtime of the port: the split-serving engine, straggler detection,
checkpoints and elastic failover."""
