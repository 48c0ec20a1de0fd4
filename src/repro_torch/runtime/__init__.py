"""Runtime of the port: the split-serving engine, the serve-step builders,
straggler detection, checkpoints and elastic failover."""
