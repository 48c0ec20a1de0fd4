"""Drive the program's split-serving engine with a cell's traffic.

Set-up builds, from the cell's configuration and the seed: the weights
(``weights.py``), the exit thresholds (one probe decode step at the cell's
batch, on fresh caches, the configured percentile of each early exit's
confidence), and ``SplitServeEngine`` wired to the FIN placement of the
configuration's scenario.  The closed loop keeps one request a client in
flight: every request that finishes is followed by its client's next at
once, so the engine's next step fills the freed slot.  A churn mix
applies one tick (``on_tick``) before every ``steps_per_tick`` steps, as
``serve_with_churn`` does.

``ServeLoop`` records what the metrics and the comparison read: each
step's position and time, each token's time, each request's slot and
first position, and each tick's duration, events and the placement then
in force.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic as TR
from . import weights as WT
from .cell import Cell

#: ModelSpec field -> the program's ArchConfig field
ARCH_FIELDS = {
    "d_model": "d_model", "n_layers": "n_layers", "vocab_size": "vocab_size",
    "n_heads": "n_heads", "n_kv_heads": "n_kv_heads", "head_dim": "head_dim",
    "d_ff": "d_ff", "n_experts": "n_experts", "top_k": "top_k",
    "rope_theta": "rope_theta", "window": "sliding_window", "eps": "norm_eps",
    "tied": "tie_embeddings", "d_state": "ssm_state",
    "ssm_head_dim": "ssm_head_dim", "expand": "ssm_expand",
    "d_conv": "ssm_conv_width",
}
#: the layer kind of the reference -> the program's one-layer pattern
PATTERNS = {"moe_attn": ("attn", "moe"), "ssm": ("ssm", "none")}


def arch_config(cell: Cell):
    """The program's configuration of the cell: the registry's entry with
    the sizes and the ``dtype`` of the configuration file, checked against
    the file."""
    from repro_torch.configs import get
    conf = cell.config
    base = get(conf["arch"])
    model = conf["model"]
    over = {f: model[k] for k, f in ARCH_FIELDS.items()
            if k in model and model[k] is not None}
    over["dtype"] = conf["dtype"]
    cfg = dataclasses.replace(base, **over)
    pattern = tuple((s.kind, s.mlp) for s in cfg.pattern)
    if pattern != (PATTERNS[model["kind"]],):
        raise ValueError(f"{cell.config_name}: the registry's {conf['arch']} "
                         f"has the layer pattern {pattern}, not "
                         f"{model['kind']}'s")
    if tuple(cfg.exit_layer_list) != tuple(model["exits"]):
        raise ValueError(f"{cell.config_name}: the program puts exits after "
                         f"periods {cfg.exit_layer_list}, the file says "
                         f"{model['exits']}")
    return cfg


def placement_inputs(conf: dict):
    """The program's Network, DNNProfile and AppRequirements built from the
    configuration's copy of the scenario."""
    from repro_torch.core import (AppRequirements, DNNProfile, ExitSpec,
                                  Network, NodeSpec)
    pl = conf["placement"]
    nw = pl["network"]
    bw = np.array([[np.inf if x is None else float(x) for x in row]
                   for row in nw["bandwidth_bps"]])
    net = Network(nodes=[NodeSpec(**n) for n in nw["nodes"]], bandwidth=bw,
                  compute=np.array(nw["compute_ops"], dtype=np.float64),
                  source_node=int(nw["source_node"]))
    pr = pl["profile"]
    prof = DNNProfile(name=pr["name"], input_bits=pr["input_bits"],
                      block_ops=list(pr["block_ops"]),
                      cut_bits=list(pr["cut_bits"]),
                      exits=[ExitSpec(**e) for e in pr["exits"]])
    req = AppRequirements(**pl["req"])
    return net, prof, req


def probe_thresholds(cfg, params, tokens: torch.Tensor, percentile: float,
                     device) -> List[float]:
    """One decode step of ``tokens`` [B, 1] at position 0 on fresh caches;
    each early exit's threshold is the ``percentile`` of its confidence
    over the B rows."""
    from repro_torch.kernels.ee_gate.ops import ee_gate
    from repro_torch.models import transformer as T
    caches = T.init_caches(cfg, tokens.shape[0], 8, device=device)
    with torch.no_grad():
        _, _, exits = T.decode_step(params, cfg, tokens, caches, 0)
        confs = {k: ee_gate(v)[0].cpu().numpy() for k, v in exits.items()}
    del caches, exits
    return [float(np.percentile(confs[f"exit_{p}"], percentile))
            for p in cfg.exit_layer_list]


@dataclass
class ReqInfo:
    index: int
    client: int
    req: object                      # the program's Request
    t_submit: float
    row: Optional[int] = None        # the engine slot it was served in
    p0: Optional[int] = None         # the position of its first step
    seen: int = 0                    # tokens seen so far
    t_last: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclass
class TickRecord:
    t0: float
    t1: float
    events: List[tuple]
    report: dict
    placement: List[int]
    final_exit: int
    degraded: bool
    paused: bool


@dataclass
class ServeLoop:
    eng: object
    requests: TR.Requests
    churn: Optional[TR.ChurnTicks] = None
    uplink_bps: float = 1e9
    steps_per_tick: int = 0
    annotate: bool = False
    infos: List[ReqInfo] = field(default_factory=list)
    live: Dict[int, ReqInfo] = field(default_factory=dict)
    step_pos: List[int] = field(default_factory=list)
    step_t: List[float] = field(default_factory=list)
    token_t: List[float] = field(default_factory=list)
    gaps: List[tuple] = field(default_factory=list)        # (t, gap s)
    ticks: List[TickRecord] = field(default_factory=list)
    initial_placement: Optional[tuple] = None
    _k: int = 0

    def submit(self, client: int) -> None:
        spec = self.requests.next(client)
        r = self.eng.submit(spec.prompt, spec.max_new_tokens)
        info = ReqInfo(spec.index, client, r, time.perf_counter())
        self.infos.append(info)
        self.live[id(r)] = info

    def fill(self, clients: int) -> None:
        for c in range(clients):
            self.submit(c)

    def _span(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def tick(self) -> None:
        from repro_torch.core.scenarios import ChurnEvent
        events = self.churn.next()
        with self._span("portbench.on_tick"):
            t0 = time.perf_counter()
            rep = self.eng.on_tick([ChurnEvent(*e) for e in events],
                                   uplink_bps=self.uplink_bps)
            t1 = time.perf_counter()
        pl = self.eng.placement
        self.ticks.append(TickRecord(t0, t1, events, rep, list(pl.placement),
                                     int(pl.final_exit),
                                     bool(self.eng.degraded),
                                     bool(self.eng.paused)))

    def step(self) -> None:
        if self.churn is not None and self._k % self.steps_per_tick == 0:
            self.tick()
        self._k += 1
        eng = self.eng
        pos = eng.pos
        with self._span("portbench.engine_step"):
            eng.step()
        now = time.perf_counter()
        if eng.pos == pos:
            return                         # paused: no step ran
        with self._span("portbench.bookkeeping"):
            self.step_pos.append(pos)
            self.step_t.append(now)
            for i, r in enumerate(eng.slots):
                if r is not None:
                    info = self.live[id(r)]
                    if info.row is None:
                        info.row, info.p0 = i, pos
            done = []
            for key, info in self.live.items():
                n = len(info.req.tokens)
                if n == info.seen:
                    continue
                if n != info.seen + 1:
                    raise RuntimeError(f"request {info.index} took "
                                       f"{n - info.seen} tokens in a step")
                if info.row is None:
                    raise RuntimeError(f"request {info.index} finished "
                                       f"without being seen in a slot")
                self.token_t.append(now)
                if info.t_first is None:
                    info.t_first = now
                else:
                    self.gaps.append((now, now - info.t_last))
                info.t_last = now
                info.seen = n
                if info.req.done:
                    info.t_done = now
                    done.append(key)
            for key in done:
                self.submit(self.live.pop(key).client)


@dataclass
class Setup:
    params: dict
    thresholds: List[float]
    eng: object
    loop: ServeLoop


def build(cell: Cell, seed: int, device: torch.device, *,
          annotate: bool = False) -> Setup:
    """Everything before the warm-up steps: weights, thresholds, the
    engine and the first requests."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve_engine import SplitServeEngine
    conf, mix = cell.config, cell.mix
    cfg = arch_config(cell)
    meta = T.init_model(cfg, device="meta")
    params = WT.make_params(meta, seed, device)
    reqs = TR.Requests(mix, seed, cfg.vocab_size)
    B = int(mix["clients"])
    serving = conf["serving"]
    probe = np.random.default_rng([seed, 3]).integers(0, cfg.vocab_size,
                                                      (B, 1))
    thresholds = probe_thresholds(
        cfg, params, torch.as_tensor(probe, device=device),
        serving["exit_threshold_percentile"], device)
    net, prof, req = placement_inputs(conf)
    pl = conf["placement"]
    churn = cell.churn
    eng = SplitServeEngine(
        cfg, params, batch_size=B, cache_len=serving["cache_len"],
        thresholds=thresholds, network=net, profile=prof, req=req,
        gamma=pl["gamma"], frontier_k=pl["frontier_k"],
        contingency=pl["contingency"], hysteresis=pl["hysteresis"],
        on_infeasible=(churn or {}).get("on_infeasible", "raise"),
        device=device)
    loop = ServeLoop(eng, reqs, annotate=annotate)
    loop.initial_placement = (list(eng.placement.placement),
                              int(eng.placement.final_exit))
    if churn is not None:
        loop.churn = TR.ChurnTicks(churn, seed)
        loop.uplink_bps = float(churn["uplink_bps"])
        loop.steps_per_tick = int(churn["steps_per_tick"])
    loop.fill(B)
    return Setup(params, thresholds, eng, loop)
