"""Carry scenario state across: build the port's host objects from plain
fields (numpy arrays and Python scalars).

Another implementation's ``Network``, ``DNNProfile``, ``AppRequirements``
or ``Config`` is handed over field by field, so both solve the same
scenario; nothing here imports that implementation.  Arrays are copied as
float64, so the port's graphs are built from byte-equal inputs.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .core.dnn_profile import DNNProfile, ExitSpec
from .core.problem import AppRequirements, Config
from .core.system_model import Network, NodeSpec

_NODE_FIELDS = ("name", "tier", "compute_ops", "power_active", "power_idle",
                "link_bps", "e_tx", "e_rx")
_EXIT_FIELDS = ("block", "ops", "out_bits", "accuracy", "phi")


def network_from_arrays(bandwidth, compute, source_node: int,
                        nodes: Sequence[Mapping]) -> Network:
    """``nodes``: one mapping per node with the ``NodeSpec`` fields."""
    specs = [NodeSpec(**{f: nd[f] for f in _NODE_FIELDS}) for nd in nodes]
    return Network(nodes=specs,
                   bandwidth=np.array(bandwidth, dtype=np.float64),
                   compute=np.array(compute, dtype=np.float64),
                   source_node=int(source_node))


def profile_from_arrays(name: str, input_bits: float,
                        block_ops: Sequence[float], cut_bits: Sequence[float],
                        exits: Sequence[Mapping]) -> DNNProfile:
    """``exits``: one mapping per exit with the ``ExitSpec`` fields."""
    return DNNProfile(
        name=name, input_bits=input_bits,
        block_ops=[float(x) for x in block_ops],
        cut_bits=list(cut_bits),
        exits=[ExitSpec(**{f: ex[f] for f in _EXIT_FIELDS}) for ex in exits])


def requirements_from(alpha: float, delta: float,
                      sigma: float = 1.0) -> AppRequirements:
    return AppRequirements(alpha=float(alpha), delta=float(delta),
                           sigma=float(sigma))


def config_from(placement: Sequence[int], final_exit: int) -> Config:
    return Config(placement=[int(p) for p in placement],
                  final_exit=int(final_exit))


def node_fields(node) -> dict:
    """The ``NodeSpec`` fields of any object that has them."""
    return {f: getattr(node, f) for f in _NODE_FIELDS}


def exit_fields(ex) -> dict:
    """The ``ExitSpec`` fields of any object that has them."""
    return {f: getattr(ex, f) for f in _EXIT_FIELDS}


def network_from(nw) -> Network:
    """The port's ``Network`` from any object with the same fields."""
    return network_from_arrays(nw.bandwidth, nw.compute, nw.source_node,
                               [node_fields(n) for n in nw.nodes])


def profile_from(pf) -> DNNProfile:
    """The port's ``DNNProfile`` from any object with the same fields."""
    return profile_from_arrays(pf.name, pf.input_bits, pf.block_ops,
                               pf.cut_bits, [exit_fields(e) for e in pf.exits])


def scenarios_from(profiles: Sequence, networks: Sequence,
                   requirements: Sequence, memo: Optional[dict] = None):
    """Parallel scenario lists carried across.  Objects shared between
    scenarios stay shared (the batched solver dedupes on identity); ``memo``
    keeps that sharing across calls."""
    memo = {} if memo is None else memo

    def once(x, fn):
        key = id(x)
        if key not in memo:
            memo[key] = (x, fn(x))       # keep x alive: ids stay unique
        return memo[key][1]

    return ([once(p, profile_from) for p in profiles],
            [once(n, network_from) for n in networks],
            [requirements_from(r.alpha, r.delta, r.sigma)
             for r in requirements])
