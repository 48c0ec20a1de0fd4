"""The benchmark of the PyTorch / CUDA port (``repro_torch``): split serving
of early-exit language models over a FIN placement, driven by data.

``run.py`` runs one cell once.  A cell is an entry of ``BENCHMARK.json``
(at the directory above this one): a configuration (``configs/<name>.json``)
under a traffic mix (``traffic/<name>.json``); its metrics are read by the
files ``e2e/<name>.py`` and ``metrics/<name>.py``.  ``reference/`` holds the
plain references that decide ``correct``, ``counts/`` the operations and
bytes the shares divide by.  Nothing here imports JAX or the JAX package.
"""
