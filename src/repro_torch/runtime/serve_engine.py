"""Split-serving engine: exit-aware continuous batching over a FIN placement.

Port of ``repro/runtime/serve_engine.py``, the paper's execution model of a
dynamic DNN:

  * every decode step runs the full stack once for the active batch (the
    attention of every attention layer through kernel B7 on the card; a
    Mamba-2 layer steps its recurrent state, an MoE layer routes each
    token to its top-k experts);
  * the exit gate (kernel B6) scores each exit's logits; a sequence whose
    confidence clears its threshold takes THAT exit's token (first exit
    wins), and deeper blocks' output for it is discarded;
  * finished sequences free their slot at once and the next queued request
    takes it (continuous batching);
  * per-token tier accounting: with a FIN placement (blocks -> tiers) the
    engine charges each token only the blocks up to its exit;
  * fault tolerance: the placement lives in a persistent ``core.Plan``
    (kernel B1 relaxes its DP on the card); ``fail_node`` masks the dead
    node and re-solves warm, ``recover_node`` unmasks; every re-split
    exposes the scenario's Pareto frontier and, with ``migration_weight >
    0``, deploys the frontier row minimising ``energy + migration_weight *
    migration_bits``;
  * O(1) failover (``contingency=True``): a ``core.contingency`` library
    precomputes the likely failure masks' solutions, so a covered failure
    or recovery installs the entry with zero DP relaxations, and the
    library refills off the critical path (at the next ``step()``);
  * graceful degradation: ``on_infeasible`` is ``"raise"`` (a typed
    ``NoFeasiblePlacement``), ``"pause"`` or ``"degrade"``;
  * churn-driven serving: ``on_tick`` applies a ``scenarios.churn_trace``
    tick, and ``serve_with_churn`` interleaves ticks with decode steps.

The engine serves every decoder architecture of the registry and keeps
the reference's behaviour to the letter, its quirks included: request ids
are ``len(queue) + 10_000``; all slots share one ``pos``; a recycled slot
keeps what its last request left in the caches (attention K/V entries at
positions below the new request's, which it attends to, and an SSM
layer's recurrent state and conv tail), as the reference's do.  Each
step copies every exit's conf and argmax to the host, two device-to-host
copies an exit (six a step at three exits), as the reference does.
The engine runs on ``device`` (default ``cuda:0``): its caches, its
parameters and its ``Plan`` live there.

While a torch profiler records, the engine opens the spans of
``runtime/tracing.py`` at its layer boundaries and keeps a
``tracing.StepRecord`` a step in ``trace_records``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..core import (AppRequirements, Config, DNNProfile, Network,
                    ParetoFrontier, Plan, migration_delta)
from ..core.contingency import (ContingencyEntry, ContingencyLibrary,
                                NoFeasiblePlacement)
from ..core.frontier import frontier_pick
from ..core.scenarios import MOBILE_UPLINK_BPS, ChurnEvent
from ..kernels.decode_attn.ops import decode_attn
from ..kernels.ee_gate.ops import ee_gate
from ..models import transformer as T
from .tracing import StepRecord, span, spanned, tracing


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    exits_taken: List[int] = field(default_factory=list)  # exit idx per token
    done: bool = False


@dataclass
class EngineStats:
    steps: int = 0
    tokens_out: int = 0
    exit_histogram: Dict[int, int] = field(default_factory=dict)
    blocks_executed: int = 0          # tier-charged block executions
    blocks_saved: int = 0             # skipped by early exits
    energy_j: float = 0.0             # placement-model energy (Eq. 2 units)
    replacements: int = 0             # FIN re-solves after failures/recovery
    blocks_migrated: int = 0          # blocks re-hosted by re-placements
    migration_bits: float = 0.0       # state bits moved by re-placements
    contingency_hits: int = 0         # failovers served from the library
    contingency_misses: int = 0       # failovers that warm re-solved
    paused_events: int = 0            # infeasible -> serving parked
    degrades: int = 0                 # infeasible -> degraded frontier row

    @property
    def measured_phi(self) -> Dict[int, float]:
        tot = max(1, sum(self.exit_histogram.values()))
        return {k: v / tot for k, v in sorted(self.exit_histogram.items())}


class SplitServeEngine:
    """Decode engine with exit-aware continuous batching.

    Prompts are consumed token-by-token through the decode path (prefill-as-
    decode keeps slot cache surgery trivial); generation then proceeds with
    gated exits.  ``placement``/``profile``/``network`` wire the engine to
    the paper's placement problem for energy accounting; they are optional —
    without them the engine is a plain continuous-batching server.
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int,
                 cache_len: int, thresholds: Optional[Sequence[float]] = None,
                 network: Optional[Network] = None,
                 profile: Optional[DNNProfile] = None,
                 req: Optional[AppRequirements] = None,
                 gamma: int = 10, seed: int = 0,
                 migration_weight: float = 0.0, frontier_k: int = 4,
                 on_infeasible: str = "raise", contingency: bool = True,
                 hysteresis: float = 0.05, device: DeviceLike = None):
        if not cfg.has_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
        self.device = resolve_device(device)
        if params["embed"]["table"].device.type != self.device.type:
            raise ValueError(f"parameters lie on "
                             f"{params['embed']['table'].device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.n_exits = len(cfg.exit_layer_list) + 1
        self.thresholds = list(thresholds) if thresholds is not None else \
            [0.9] * (self.n_exits - 1)
        self.caches = T.init_caches(cfg, batch_size, cache_len,
                                    device=self.device)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: List[Request] = []
        self.stats = EngineStats()
        self.pos = 0
        self._slot_len = np.zeros(batch_size, np.int32)
        #: one record a step served while a profiler recorded
        self.trace_records: List[StepRecord] = []
        # placement integration: a persistent Plan owns the built pipeline
        # state, so failure/recovery re-solves are warm deltas
        self.profile = profile
        self.app_req = req
        self.gamma = gamma
        self.plan: Optional[Plan] = None
        self.placement: Optional[Config] = None
        self.network = network
        if migration_weight < 0:
            raise ValueError(f"migration_weight must be >= 0, got "
                             f"{migration_weight}")
        if frontier_k < 1:
            raise ValueError(f"frontier_k must be >= 1, got {frontier_k}")
        self.migration_weight = float(migration_weight)
        self.frontier_k = int(frontier_k)
        if on_infeasible not in ("raise", "pause", "degrade"):
            raise ValueError(f"on_infeasible must be 'raise', 'pause' or "
                             f"'degrade', got {on_infeasible!r}")
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.on_infeasible = on_infeasible
        self.hysteresis = float(hysteresis)
        #: graceful-degradation state: ``paused`` parks serving (step() is
        #: a no-op) until a topology/channel change restores feasibility;
        #: ``degraded`` flags a placement adopted off the last feasible
        #: frontier instead of a fresh solve
        self.paused = False
        self.degraded = False
        self._ref_energy = np.inf          # hysteresis reference (on_tick)
        self._last_feasible_frontier: Optional[ParetoFrontier] = None
        #: the Pareto frontier of the last (re-)placement — refreshed on
        #: every failover / recovery re-split (core/frontier.py)
        self.frontier: Optional[ParetoFrontier] = None
        #: precomputed-failover library (core/contingency.py), refilled off
        #: the failover critical path; None when placement is not wired or
        #: ``contingency=False``
        self.contingency: Optional[ContingencyLibrary] = None
        self._contingency_dirty = False
        if network is not None and profile is not None and req is not None:
            self.plan = Plan(network, profile, req, gamma=gamma,
                             device=self.device)
            sol = self.plan.solve()
            if not sol.feasible:
                raise NoFeasiblePlacement(
                    [], None, "no feasible FIN placement for the initial "
                              "network")
            self.placement = sol.config
            self.frontier = self.plan.frontier(k_per_exit=self.frontier_k)
            self.network = self.plan.network   # live view of current state
            self._ref_energy = sol.energy
            if len(self.frontier):
                self._last_feasible_frontier = self.frontier
            if contingency:
                self.contingency = ContingencyLibrary(
                    self.plan, k_per_exit=self.frontier_k)
                self.contingency.refill(base_config=self.placement)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: Sequence[int], max_new_tokens: int) -> Request:
        r = Request(rid=len(self.queue) + 10_000, prompt=list(prompt),
                    max_new_tokens=max_new_tokens)
        self.queue.append(r)
        return r

    def _require_plan(self) -> None:
        if self.plan is None:
            raise RuntimeError(
                "engine has no placement plan: construct SplitServeEngine "
                "with network=, profile= and req= to enable failover")

    def _check_node(self, node_idx: int) -> int:
        if not isinstance(node_idx, (int, np.integer)):
            raise ValueError(f"node_idx must be an integer, got "
                             f"{type(node_idx).__name__}")
        n = int(node_idx)
        if not 0 <= n < self.plan.n_nodes:
            raise ValueError(f"node_idx {n} out of range for the "
                             f"{self.plan.n_nodes}-node network")
        return n

    def fail_node(self, node_idx: int) -> None:
        """Node failure: mask the node and re-split.

        The plan keeps its node indexing (the placement simply avoids the
        dead node), so tier accounting and any in-flight references stay
        valid.  With the contingency library covering the resulting mask
        the new placement is *installed* — zero DP relaxations, bit-exact
        vs the warm re-solve; otherwise this is the warm re-solve (cached
        pipeline state; bit-exact vs a cold solve on the reduced
        network), and the miss is recorded."""
        self.fail_nodes([node_idx])

    @spanned("plan.failover")
    def fail_nodes(self, node_idxs: Sequence[int]) -> None:
        """Simultaneous (correlated) failure of several nodes: ONE joint
        mask, ONE lookup/re-solve, ONE re-split — a tier-wide outage whose
        joint mask the library covers is as O(1) as a single failure."""
        self._require_plan()
        nodes = [self._check_node(n) for n in node_idxs]
        src = self.plan.network.source_node
        if src in nodes:
            raise ValueError("cannot mask the source-hosting node")
        if not nodes:
            return
        prospective = self.plan._masked.copy()
        prospective[nodes] = True
        entry = (self.contingency.lookup(prospective)
                 if self.contingency is not None else None)
        for n in nodes:
            self.plan.mask_node(n)
        self._after_topology(entry)

    @spanned("plan.failover")
    def recover_node(self, node_idx: int) -> None:
        """Node recovery: unmask and re-split (may migrate back) — same
        library-hit / warm-fallback protocol as ``fail_node``."""
        self._require_plan()
        n = self._check_node(node_idx)
        prospective = self.plan._masked.copy()
        prospective[n] = False
        entry = (self.contingency.lookup(prospective)
                 if self.contingency is not None else None)
        self.plan.unmask_node(n)
        self._after_topology(entry)

    def _after_topology(self, entry: Optional[ContingencyEntry]) -> None:
        """Re-split after a mask change: install the library entry (hit:
        zero DP relaxations, migration pre-priced) or warm re-solve
        (miss).  Either way the library is now keyed off a stale base
        mask — mark it dirty; the refill runs OFF this critical path, at
        the next serving step / explicit ``refresh_contingency``."""
        if entry is not None:
            self.stats.contingency_hits += 1
            sol = self.plan.install_solution(entry.solution, dps=entry.dps)
            self._resplit(sol, entry.frontier, priced=entry)
        else:
            if self.contingency is not None:
                self.stats.contingency_misses += 1
            self._replace()
        self._contingency_dirty = True

    def _replace(self) -> None:
        """Warm re-solve + frontier-aware re-split (the library-miss and
        channel-churn path)."""
        with span("plan.resolve"):
            sol = self.plan.solve()
            fr = self.plan.frontier(k_per_exit=self.frontier_k)
        self._resplit(sol, fr)

    def _resplit(self, sol, fr: ParetoFrontier,
                 priced: Optional[ContingencyEntry] = None) -> None:
        """Deploy a re-solve result (fresh or library-installed).

        The scenario's Pareto frontier is exposed on every re-split
        (``self.frontier``); with ``migration_weight > 0`` the new
        placement is the option minimizing ``energy + migration_weight *
        migration_bits`` over the frontier rows AND the current placement
        (if it is still feasible — after a recovery, keeping the current
        hosts avoids migrating every block back for a marginal win).
        ``migration_weight=0`` deploys the argmin row.  ``priced`` is the
        library entry whose build-time migration price is reused when the
        deployed transition is exactly the priced one."""
        old = self.placement
        self.frontier = fr
        choice = sol.config
        energy = sol.energy
        if self.migration_weight > 0 and old is not None:
            ev_old = self.plan.evaluate(old)
            choice, energy, _moved, _bits, _kept = frontier_pick(
                fr, old, ev_old.feasible, ev_old.energy, self.profile,
                self.migration_weight)
            if choice is not None and (
                    not sol.feasible
                    or choice.placement != sol.config.placement
                    or choice.final_exit != sol.config.final_exit):
                self.plan.adopt(choice)     # a non-argmin frontier choice
        if choice is None:
            self._handle_infeasible(old)
            return
        self.paused = False
        self.degraded = False
        self.placement = choice
        self._ref_energy = energy
        if len(fr):
            self._last_feasible_frontier = fr
        self.stats.replacements += 1
        if (priced is not None and sol.feasible and old is not None
                and priced.base_config is not None
                and old.placement == priced.base_config.placement
                and old.final_exit == priced.base_config.final_exit
                and choice.placement == sol.config.placement
                and choice.final_exit == sol.config.final_exit):
            moved, bits = priced.moved, priced.bits
        else:
            moved, bits = migration_delta(self.profile, old, choice)
        self.stats.blocks_migrated += moved
        self.stats.migration_bits += bits

    def _handle_infeasible(self, old: Optional[Config]) -> None:
        """No feasible placement under the current mask: apply the
        ``on_infeasible`` policy."""
        masked = self.plan.masked_nodes
        if self.on_infeasible == "degrade":
            lf = self._last_feasible_frontier
            row = lf.cheapest_avoiding(masked) if lf is not None else None
            if row is not None:
                self.placement = row.config
                self.plan.adopt(row.config)
                self.degraded = True
                self.paused = False
                self._ref_energy = row.energy
                self.stats.degrades += 1
                self.stats.replacements += 1
                moved, bits = migration_delta(self.profile, old, row.config)
                self.stats.blocks_migrated += moved
                self.stats.migration_bits += bits
                return
            # every historical row routes through a dead node: park instead
        if self.on_infeasible in ("pause", "degrade"):
            self.paused = True
            self.stats.paused_events += 1
            return
        raise NoFeasiblePlacement(masked, self._last_feasible_frontier)

    # ----------------------------------------------------- contingency admin
    @spanned("serve.refill")
    def refresh_contingency(self) -> int:
        """Rebuild the contingency library around the current (mask,
        channel) state; returns the number of entries built.  Runs
        automatically before serving steps when the library is dirty or
        environment-stale — call explicitly to control when the (warm,
        off-critical-path) build cost is paid."""
        if self.contingency is None:
            return 0
        n = self.contingency.refill(base_config=self.placement)
        self._contingency_dirty = False
        return n

    def _maybe_refill(self) -> None:
        if self.contingency is not None and (
                self._contingency_dirty or self.contingency.stale):
            self.refresh_contingency()

    # ------------------------------------------------------------ churn tick
    @spanned("serve.tick")
    def on_tick(self, events: Sequence[ChurnEvent], *,
                uplink_bps: float = MOBILE_UPLINK_BPS) -> Dict[str, object]:
        """Apply one ``scenarios.churn_trace`` tick to the serving plan.

        Uplink fades rescale the source links (``value`` is the AR(1)
        quality factor on ``uplink_bps``) and re-split only when the
        incumbent placement leaves the hysteresis band (infeasible, or
        energy above ``(1 + hysteresis) * ref``); failures are applied as
        ONE joint mask (a tier outage covered by the library is a single
        O(1) hit) and recoveries individually, all through the
        contingency protocol.  The engine serves a single user — drive it
        with ``churn_trace(n_users=1, p_move=0.0, ...)``; ``attach``
        events raise.  Returns a per-tick report dict.
        """
        self._require_plan()
        fails: List[int] = []
        recovers: List[int] = []
        chan = False
        for ev in events:
            if ev.kind == "fail":
                fails.append(int(ev.value))
            elif ev.kind == "recover":
                recovers.append(int(ev.value))
            elif ev.kind == "uplink":
                with span("plan.channel"):
                    self.plan.update_uplink(uplink_bps * float(ev.value))
                chan = True
            elif ev.kind == "slice":
                with span("plan.channel"):
                    self.plan.update_slice(ev.value)
                chan = True
            else:
                raise ValueError(
                    f"unsupported churn event kind {ev.kind!r} for the "
                    f"single-user engine (generate traces with p_move=0)")
        resplit = held = False
        if chan:
            if self.paused:
                self._replace()            # re-attempt under the new channel
                resplit = True
            elif self.placement is not None:
                with span("plan.hold"):
                    ev_inc = self.plan.evaluate(self.placement)
                if ev_inc.feasible and ev_inc.energy <= \
                        self._ref_energy * (1.0 + self.hysteresis):
                    held = True
                else:
                    self._replace()
                    resplit = True
            # the channel moved: re-key the library NOW so this tick's own
            # failures can still hit precomputed entries
            self._maybe_refill()
        fails = [n for n in fails if not self.plan._masked[n]]
        recovers = [n for n in recovers if self.plan._masked[n]]
        h0 = self.contingency.stats.hits if self.contingency else 0
        m0 = self.contingency.stats.misses if self.contingency else 0
        if fails:
            self.fail_nodes(fails)
            resplit = True
        for n in recovers:
            self.recover_node(n)
            resplit = True
        if fails or recovers:
            self._maybe_refill()
        return {
            "resplit": resplit, "held": held,
            "n_fail": len(fails), "n_recover": len(recovers),
            "contingency_hits":
                (self.contingency.stats.hits if self.contingency else 0) - h0,
            "contingency_misses":
                (self.contingency.stats.misses if self.contingency else 0)
                - m0,
            "paused": self.paused, "degraded": self.degraded,
        }

    def run(self, *, max_steps: int = 10_000) -> EngineStats:
        while (any(self.slots) or self.queue) and not self.paused \
                and self.stats.steps < max_steps:
            self.step()
        return self.stats

    # ----------------------------------------------------------------- step
    def _fill_slots(self) -> None:
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)
                self._slot_len[i] = 0

    def _charge(self, exit_idx: int) -> None:
        """Tier accounting for one emitted token at the given exit."""
        st = self.stats
        st.exit_histogram[exit_idx] = st.exit_histogram.get(exit_idx, 0) + 1
        if self.profile is None or self.placement is None:
            return
        prof, place = self.profile, self.placement
        last_block = prof.exits[min(exit_idx, prof.n_exits - 1)].block
        nw = self.network
        for b in range(prof.n_blocks):
            if b <= last_block:
                st.blocks_executed += 1
                n = place.placement[min(b, len(place.placement) - 1)]
                t_comp = prof.block_ops_with_exit(b, prof.n_exits - 1) \
                    / nw.compute[n]
                st.energy_j += nw.power_active[n] * t_comp
                if b < last_block:
                    n2 = place.placement[min(b + 1, len(place.placement) - 1)]
                    if n2 != n:
                        st.energy_j += (nw.e_tx[n] + nw.e_rx[n2]) \
                            * prof.cut_bits[b]
            else:
                st.blocks_saved += 1

    @spanned("serve.step")
    def step(self) -> None:
        if self.paused:
            return                # parked until feasibility is restored
        self._maybe_refill()      # background contingency refill (off the
        #                           failover critical path)
        with span("serve.admit"):
            self._fill_slots()
            if not any(self.slots):
                return
            toks = np.zeros((self.B, 1), np.int32)
            for i, r in enumerate(self.slots):
                if r is None:
                    continue
                consumed = int(self._slot_len[i])
                if consumed < len(r.prompt):
                    toks[i, 0] = r.prompt[consumed]
                else:
                    toks[i, 0] = r.tokens[-1] if r.tokens else r.prompt[-1]

        record = tracing()
        if record:
            pos, rows = self.pos, self.B - self.slots.count(None)
            out0 = self.stats.tokens_out
            read0, held0 = decode_attn.slots_read, decode_attn.slots_held
        with span("serve.decode"):
            logits, self.caches, exits = T.decode_step(
                self.params, self.cfg,
                torch.as_tensor(toks, device=self.device), self.caches,
                self.pos)
        self.pos += 1
        self.stats.steps += 1

        # gate every exit with the fused kernel; first-exit-wins.  Each
        # exit's conf and argmax come to the host: two copies an exit
        with span("serve.gates"):
            confs, args = [], []
            for p_idx in self.cfg.exit_layer_list:
                c, a = ee_gate(exits[f"exit_{p_idx}"])
                confs.append(c.cpu().numpy())
                args.append(a.cpu().numpy())
            c_f, a_f = ee_gate(logits)
            confs.append(c_f.cpu().numpy())
            args.append(a_f.cpu().numpy())

        with span("serve.emit"):
            for i, r in enumerate(self.slots):
                if r is None:
                    continue
                self._slot_len[i] += 1
                if self._slot_len[i] < len(r.prompt):
                    continue  # still consuming the prompt
                exit_idx = self.n_exits - 1
                for j in range(self.n_exits - 1):
                    if confs[j][i] >= self.thresholds[j]:
                        exit_idx = j
                        break
                token = int(args[exit_idx][i])
                r.tokens.append(token)
                r.exits_taken.append(exit_idx)
                self.stats.tokens_out += 1
                self._charge(exit_idx)
                if len(r.tokens) >= r.max_new_tokens:
                    r.done = True
                    self.slots[i] = None   # continuous batching: free the slot
        if record:
            emitted = self.stats.tokens_out - out0
            self.trace_records.append(StepRecord(
                pos, rows - emitted, emitted,
                decode_attn.slots_read - read0,
                decode_attn.slots_held - held0))

def serve_with_churn(engine: SplitServeEngine,
                     trace: Sequence[Sequence[ChurnEvent]], *,
                     steps_per_tick: int = 1,
                     uplink_bps: float = MOBILE_UPLINK_BPS
                     ) -> List[Dict[str, object]]:
    """Serve through a churn trace: per tick, apply the events
    (``engine.on_tick`` — re-splits, failovers, library refills) then run
    ``steps_per_tick`` decode steps (no-ops while the engine is paused).
    Returns the per-tick reports."""
    if steps_per_tick < 0:
        raise ValueError(f"steps_per_tick must be >= 0, got {steps_per_tick}")
    reports: List[Dict[str, object]] = []
    for events in trace:
        rep = engine.on_tick(events, uplink_bps=uplink_bps)
        for _ in range(steps_per_tick):
            engine.step()
        reports.append(rep)
    return reports
