"""The early-exit confidence gate (B6) and the population tick's fused
ingest (B2): CUDA sources, wrappers and their plain PyTorch versions;
``population.py`` holds the ingest's constants bundle and numpy oracle."""
