"""Shared node/link capacity across the population: congestion pricing.

Port of ``repro/core/capacity.py``.  Everything here is host float64
numpy over the cohorts' host incumbents (``_inc_place``, ``_inc_exit``,
``_inc_energy``): the grouped load reduction fixes its order of sums, and
the price factors ``base * step ** (-k * w)`` are numpy's (a device
reciprocal differs in the last bit), so prices and loads are bit-equal to
the reference's.  The repriced cohorts re-solve on their own device.

Every solver before this module treats users as independent — a
population tick is U private copies of the edge, so nothing stops the
engine from placing ten thousand users on one edge node.  The paper's
system model, however, makes (3d)/(3e) *shared* constraints: a node's
compute slice and a link's backhaul serve the whole population.  This
module closes that gap with a congestion-priced fixed point over the
struct-of-arrays cohorts:

  :class:`SharedCapacity`      the shared budget — per-node compute
                               (ops/s) and per-link backhaul (bits/s)
                               capacities, with the price-grid and
                               iteration-cap parameters;
  :func:`accumulate_loads`     the vectorized population load accumulator:
                               incumbents group by (exit, placement) via
                               the SoA void-view idiom, each distinct
                               configuration contributes ONE load row
                               (computed by the shared ``problem.
                               config_node_loads`` / ``config_link_loads``
                               scalar arithmetic) times its user count —
                               a deterministic grouped reduction the
                               oracle tests replay term by term;
  :class:`CongestionController`
                               the fixed-point repricer + admission
                               control driven by ``ChurnOrchestrator``
                               (``shared_capacity=``) after every tick.

Price model.  Prices live on a geometric grid: each resource carries an
integer exponent ``k`` and its price is ``price_step ** k``, capped at
``price_cap``.  Exponents only ever ratchet UP (within a tick and across
ticks — the fixed point warm-starts from the previous tick's prices), so
the loop terminates: every iteration either converges (no overload) or
bumps at least one exponent toward the cap.  A price ``p`` on node ``n``
is applied as the typed delta ``Population.update_slice`` with per-node
factor ``base * p ** -w`` (the node serves ``base * compute / p^w``:
compute latency AND compute energy rise by the price — Eq. 2's compute
term is ``P_active * ops / c``), where ``base`` is the cohort's last
renegotiated slice fraction — ``update_slice`` writes absolutely, so
slice churn events must route through :meth:`CongestionController.
renegotiate_slice`, which composes the two factors and re-syncs the
applied-price keys instead of letting either clobber the other; a link
price applies as ``Population.update_backhaul`` with factor ``p ** -w``
relative to the pristine bandwidths.  ``w`` is the cohort's fairness weight (``multiapp.
app_price_weights``): ``w == 0`` exempts a cohort from repricing
entirely, fractional ``w`` softens how hard congestion steers it.
Because both deltas ride the Plan IR's typed-update paths, the
cohort-state dedupe and the warm DP machinery keep working — a reprice
is one proto update plus a cohort re-key, not U rebuilds.

Admission.  Pricing steers, but discrete demand means it cannot
guarantee feasibility: when the loop ends with residual overload (price
cap or iteration cap hit), a deterministic eviction pass picks the most
overloaded resource (max load/cap ratio; nodes before links, lowest
index on ties) and its largest contributor (largest per-config load row
entry; largest global user id on ties).  A first-time victim degrades:
the cheapest of its Pareto-frontier rows whose adoption leaves
every capacity satisfied replaces its incumbent; a repeat victim — or
one with no fitting row — is rejected (incumbent cleared).  Re-admission
passes then sweep the unplaced users in ascending global id, adopting
the cheapest fitting frontier row, until a pass admits no one.  The
resulting contract, property-tested against the brute-force oracle:
zero capacity violations among admitted users, and every user left
unplaced has NO frontier row that fits the final residual capacity at
the final prices.

Exactness.  With every capacity infinite (or simply no overload at the
current prices and no prior congestion state), the controller is a pure
read-only pass — it accumulates loads, observes convergence and touches
NOTHING, so coupled ticks are bit-exact vs the uncoupled Population
path.  All admission capacity checks recompute the population loads
from scratch through the same canonical grouped reduction, so "fits"
during the tick and "no violation" in the post-hoc oracle are the same
IEEE-double comparison.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .population import Population, _group_runs
from .problem import Config, config_link_loads, config_node_loads

__all__ = ["SharedCapacity", "CongestionReport", "CongestionController",
           "accumulate_loads", "config_load_rows"]


@dataclass
class SharedCapacity:
    """The population-shared resource budget + repricer parameters.

    ``node_cap`` is the (N,) per-node compute capacity in ops/s shared by
    every user's deployed blocks; ``link_cap`` the (N, N) per-directed-link
    backhaul in bits/s shared by every user's transfers.  ``inf`` entries
    are unshared (per-user private) resources; the source node's compute,
    its links and the diagonal are forced private by the controller — the
    paper's mobile device and radio link belong to one user each, only the
    edge/cloud infrastructure is contended.

    ``price_step`` (> 1) is the geometric price grid's base,
    ``price_cap`` the largest price a resource can reach, ``max_iters``
    the fixed-point iteration cap per tick.
    """

    node_cap: np.ndarray
    link_cap: np.ndarray
    price_step: float = 2.0
    price_cap: float = 4096.0
    max_iters: int = 16

    def __post_init__(self) -> None:
        self.node_cap = np.asarray(self.node_cap, dtype=np.float64)
        self.link_cap = np.asarray(self.link_cap, dtype=np.float64)
        if self.node_cap.ndim != 1:
            raise ValueError(f"node_cap must be (N,), got shape "
                             f"{self.node_cap.shape}")
        N = len(self.node_cap)
        if self.link_cap.shape != (N, N):
            raise ValueError(f"link_cap must be ({N}, {N}) to match "
                             f"node_cap, got shape {self.link_cap.shape}")
        if np.any(self.node_cap <= 0) or np.any(self.link_cap <= 0) \
                or np.any(np.isnan(self.node_cap)) \
                or np.any(np.isnan(self.link_cap)):
            raise ValueError("capacities must be positive (inf = unshared)")
        if not self.price_step > 1.0:
            raise ValueError(f"price_step must be > 1, got "
                             f"{self.price_step}")
        if not self.price_cap >= self.price_step:
            raise ValueError(f"price_cap must be >= price_step, got "
                             f"{self.price_cap}")
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got "
                             f"{self.max_iters}")

    @classmethod
    def infinite(cls, n_nodes: int, **kw) -> "SharedCapacity":
        """The uncoupled limit: every resource unshared (the controller
        degenerates to a read-only load probe — bit-exact vs no capacity
        at all)."""
        return cls(node_cap=np.full(n_nodes, np.inf),
                   link_cap=np.full((n_nodes, n_nodes), np.inf), **kw)

    @property
    def k_max(self) -> int:
        """Largest price exponent on the grid (``step ** k <= cap``)."""
        k = 0
        while self.price_step ** (k + 1) <= self.price_cap * (1 + 1e-12):
            k += 1
        return k


def config_load_rows(profile, config: Config, sigma: float, n_nodes: int,
                     src: int) -> Tuple[np.ndarray, np.ndarray]:
    """One configuration's (node_load (N,), link_load (N, N)) rows —
    the shared scalar (3d+)/(3e) arithmetic of ``problem.py`` scattered
    into dense arrays.  Duplicate link terms (a placement crossing the
    same link twice) accumulate in placement order."""
    nrow = np.array(config_node_loads(profile, config, sigma, n_nodes))
    lrow = np.zeros((n_nodes, n_nodes))
    for a, b, x in config_link_loads(profile, config, src, sigma):
        lrow[a, b] += x
    return nrow, lrow


def accumulate_loads(pops: Sequence[Population],
                     return_groups: bool = False):
    """Population-wide (node_load (N,), link_load (N, N)) over every
    feasible incumbent, via the SoA arrays.

    Canonical aggregation semantics (the determinism + oracle contract):
    each cohort's incumbents group by their (exit, placement) rows with
    the ``_group_runs`` void-view idiom (``np.unique`` byte order); each
    distinct configuration contributes ``count * row`` where ``row`` is
    the scalar-exact per-config load (``config_load_rows``), and groups
    accumulate into the totals in (cohort order, group order).  The
    multiply-by-count is ONE rounded IEEE operation per entry — NOT a
    repeated addition — so a scalar replay of the same grouped reduction
    reproduces the sums bit for bit, which is what the capacity checks
    during admission and the post-hoc violation oracle rely on.

    ``return_groups`` additionally returns the per-group structure
    ``[(pop_index, config, members_local, node_row, link_row), ...]``
    in accumulation order (the admission pass's contributor lookup).
    """
    N = pops[0].N
    node_load = np.zeros(N)
    link_load = np.zeros((N, N))
    groups: List[Tuple[int, Config, np.ndarray, np.ndarray, np.ndarray]] = []
    for pi, p in enumerate(pops):
        idx = np.nonzero(p.inc_found)[0]
        if not len(idx):
            continue
        rows = np.empty((len(idx), 1 + p.L), dtype=np.int32)
        rows[:, 0] = p._inc_exit[idx]
        rows[:, 1:] = p._inc_place[idx]
        v = np.ascontiguousarray(rows).view(
            np.dtype((np.void, rows.shape[1] * 4))).ravel()
        _, first, order, bounds = _group_runs(v)
        for g, j in enumerate(first):
            k = int(rows[j, 0])
            nb = p.profile.exits[k].block + 1
            cfg = Config(placement=[int(x) for x in rows[j, 1:1 + nb]],
                         final_exit=k)
            members = idx[order[bounds[g]:bounds[g + 1]]]
            nrow, lrow = config_load_rows(p.profile, cfg, p.req.sigma, N,
                                          p.src)
            cnt = float(len(members))
            node_load += cnt * nrow
            link_load += cnt * lrow
            if return_groups:
                groups.append((pi, cfg, members, nrow, lrow))
    if return_groups:
        return node_load, link_load, groups
    return node_load, link_load


@dataclass
class CongestionReport:
    """What one congestion pass (``CongestionController.run_tick``) did."""

    iterations: int = 0          # fixed-point iterations (load evaluations)
    converged: bool = False      # no overload at the final prices
    capped: bool = False         # residual overload with all prices capped
    touched: bool = False        # any reprice / eviction / re-admission
    n_repriced: int = 0          # cohort reprice+re-solve passes issued
    n_evicted: int = 0           # eviction decisions (degrades + rejects)
    n_degraded: int = 0          # victims moved to a fitting frontier row
    n_rejected: int = 0          # victims whose incumbent was cleared
    n_readmitted: int = 0        # unplaced users re-admitted on a row
    n_priced_nodes: int = 0      # nodes with price > 1 after the tick
    n_priced_links: int = 0      # links with price > 1 after the tick
    max_node_util: float = 0.0   # peak load/cap seen (finite caps)
    max_link_util: float = 0.0
    unplaced_ids: List[int] = field(default_factory=list)
    #: global ids whose incumbent (found flag, config or energy) actually
    #: changed during the pass — the orchestrator re-arms its hysteresis
    #: baseline for exactly these users, nobody else
    moved_gids: List[int] = field(default_factory=list)


class CongestionController:
    """Owns the population's price exponents and runs the per-tick fixed
    point + admission control (see the module docstring for the model).

    Prices persist across ticks (monotone ratchet, warm start); the
    orchestrator calls :meth:`run_tick` after its normal churn tick so the
    fixed point starts from incumbents already solved against the current
    priced tensors.
    """

    def __init__(self, capacity: SharedCapacity,
                 pops: Sequence[Population], *,
                 weights: Optional[Sequence[float]] = None,
                 frontier_k: int = 4):
        self.capacity = capacity
        self.pops = list(pops)
        if not self.pops:
            raise ValueError("shared capacity needs at least one cohort")
        N = self.pops[0].N
        src = self.pops[0].src
        for p in self.pops:
            if p.N != N or p.src != src:
                raise ValueError("shared capacity requires cohorts on one "
                                 "network topology")
        if len(capacity.node_cap) != N:
            raise ValueError(f"capacity is for {len(capacity.node_cap)} "
                             f"nodes but the population has {N}")
        # the source node's compute, its links and self-loops are per-user
        # private (the paper's mobile device + radio) — never contended
        node_cap = capacity.node_cap.copy()
        link_cap = capacity.link_cap.copy()
        node_cap[src] = np.inf
        link_cap[src, :] = np.inf
        link_cap[:, src] = np.inf
        np.fill_diagonal(link_cap, np.inf)
        self.node_cap = node_cap
        self.link_cap = link_cap
        if weights is None:
            self.weights = [1.0] * len(self.pops)
        else:
            self.weights = [float(w) for w in weights]
            if len(self.weights) != len(self.pops):
                raise ValueError(f"price_weights has {len(self.weights)} "
                                 f"entries for {len(self.pops)} cohorts")
            if any(w < 0 for w in self.weights):
                raise ValueError("price_weights must be >= 0")
        self.frontier_k = int(frontier_k)
        self.step = float(capacity.price_step)
        self.k_max = capacity.k_max
        self.node_k = np.zeros(N, dtype=np.int64)
        self.link_k = np.zeros((N, N), dtype=np.int64)
        # per-cohort applied price-cell keys: exponents == applied key means
        # the cohort's tensors already carry these prices — no delta, no
        # re-solve (the "re-solve only cohorts whose price cell changed"
        # rule).  Zero exponents are applied by construction.
        self._applied_node = [self.node_k.tobytes()] * len(self.pops)
        self._applied_link = [self.link_k.tobytes()] * len(self.pops)
        # per-cohort renegotiated base slice: Plan.update_slice writes the
        # slice fraction ABSOLUTELY, so the applied factor is always
        # base * step**(-k*w) — slice churn must route through
        # :meth:`renegotiate_slice` while a controller owns the cohorts
        self._base_slice = [np.ones(N) for _ in self.pops]
        #: has the controller EVER written cohort pi's slice?  Restore must
        #: not install ``base_slice`` (ones) over a cohort whose original
        #: plan carried a non-unit slice the controller never touched.
        self._slice_set = [False] * len(self.pops)
        # canonical loads of the current incumbent set (admission's cheap
        # screening state; refreshed by every tracked reduction)
        self._load_n: Optional[np.ndarray] = None
        self._load_l: Optional[np.ndarray] = None
        #: becomes True on the first mutation ever; until then every tick
        #: is a pure read-only probe (bit-exactness vs the uncoupled path)
        self._active = False

    # ------------------------------------------------------------- prices
    @property
    def node_price(self) -> np.ndarray:
        """(N,) current node prices (``step ** k``)."""
        return self.step ** self.node_k.astype(np.float64)

    @property
    def link_price(self) -> np.ndarray:
        """(N, N) current link prices."""
        return self.step ** self.link_k.astype(np.float64)

    def _apply_prices(self) -> int:
        """Push the current exponents into every weighted cohort whose
        applied price cell moved, as typed Population deltas, and re-solve
        those cohorts against the repriced tensors.  Returns the number of
        cohorts repriced."""
        nk = self.node_k.tobytes()
        lk = self.link_k.tobytes()
        n_applied = 0
        for pi, p in enumerate(self.pops):
            w = self.weights[pi]
            if w == 0.0:
                continue                 # exempt: never repriced/re-solved
            node_moved = self._applied_node[pi] != nk
            link_moved = self._applied_link[pi] != lk
            if not node_moved and not link_moved:
                continue
            if node_moved:
                # compose with the cohort's renegotiated base slice —
                # update_slice is absolute, a bare price factor would
                # silently discard a prior slice event (and vice versa)
                frac = self._base_slice[pi] \
                    * self.step ** (-self.node_k.astype(np.float64) * w)
                p.update_slice(frac)
                self._applied_node[pi] = nk
                self._slice_set[pi] = True
            if link_moved:
                scale = self.step ** (-self.link_k.astype(np.float64) * w)
                p.update_backhaul(scale)
                self._applied_link[pi] = lk
            # repriced tensors invalidate every user's argmin in this
            # cohort — re-solve them all (hysteresis does not apply to a
            # price move; it is a tensor change, like a slice event)
            p.solve(build_solutions=False)
            n_applied += 1
        return n_applied

    def renegotiate_slice(self, value) -> None:
        """Apply a cohort-shared slice re-negotiation (a ``"slice"`` churn
        event) COMPOSED with the current congestion prices.

        ``Plan.update_slice`` writes the slice fraction absolutely, so a
        raw ``Population.update_slice(value)`` would clobber any applied
        price factor while the applied-exponent keys still claim it is in
        effect — and the next reprice would in turn discard the
        renegotiated fraction.  Routing the event through here installs
        ``base * step**(-k*w)`` per node and re-syncs the applied keys, so
        both factors survive each other.  With every exponent at zero the
        composed factor is bit-exactly ``base`` (``step**0 == 1`` and
        ``x * 1.0`` is exact), keeping un-priced coupled ticks bit-exact
        vs the uncoupled path.  Does not re-solve: the caller's tick marks
        every user dirty and re-checks them through its normal gate.
        """
        N = len(self.node_cap)
        for pi, p in enumerate(self.pops):
            base = np.broadcast_to(
                np.asarray(value, dtype=np.float64), (N,)).copy()
            if np.any(~np.isfinite(base)) or np.any(base <= 0):
                raise ValueError("slice fractions must be finite and > 0")
            self._base_slice[pi] = base
            w = self.weights[pi]
            p.update_slice(
                base * self.step ** (-self.node_k.astype(np.float64) * w))
            self._applied_node[pi] = self.node_k.tobytes()
            self._slice_set[pi] = True

    # --------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """The controller's crash-consistent state as plain arrays: the
        price exponents, the per-cohort applied price cells, the
        renegotiated base slices and the activity flag.  The running load
        totals (``_load_n``/``_load_l``) are derived state — the next
        ``run_tick`` recomputes them from the incumbents and the admission
        screen safely falls through to the canonical check while they are
        unset."""
        N = len(self.node_cap)
        return {
            "node_k": self.node_k.copy(),
            "link_k": self.link_k.copy(),
            "applied_node": np.stack([np.frombuffer(b, dtype=np.int64)
                                      for b in self._applied_node]),
            "applied_link": np.stack(
                [np.frombuffer(b, dtype=np.int64).reshape(N, N)
                 for b in self._applied_link]),
            "base_slice": np.stack(self._base_slice),
            "slice_set": np.asarray(self._slice_set, dtype=bool),
            "active": np.asarray(self._active),
        }

    def restore_state(self, d: dict) -> None:
        """Restore :meth:`state_dict` and RE-INSTALL the crash-time priced
        tensors into every cohort.  The applied factors are absolute with
        respect to the construction-time snapshots (``update_slice`` writes
        the fraction, ``update_backhaul`` scales the pristine bandwidths),
        so one application of the composed final factors reproduces the
        crash-time tensors bit-exactly — the caller then restores each
        cohort's SoA state on top (``Population.restore_state``), whose
        re-relaxations read these tensors."""
        P = len(self.pops)
        N = len(self.node_cap)
        an = np.ascontiguousarray(np.asarray(d["applied_node"],
                                             dtype=np.int64))
        al = np.ascontiguousarray(np.asarray(d["applied_link"],
                                             dtype=np.int64))
        bs = np.asarray(d["base_slice"], dtype=np.float64)
        ss = np.asarray(d["slice_set"], dtype=bool)
        if an.shape != (P, N) or al.shape != (P, N, N) \
                or bs.shape != (P, N) or ss.shape != (P,):
            raise ValueError(
                f"congestion checkpoint shaped for {an.shape[0]} cohorts x "
                f"{an.shape[-1]} nodes, controller has {P} x {N}")
        self.node_k[:] = np.asarray(d["node_k"], dtype=np.int64)
        self.link_k[:] = np.asarray(d["link_k"], dtype=np.int64)
        self._applied_node = [an[pi].tobytes() for pi in range(P)]
        self._applied_link = [al[pi].tobytes() for pi in range(P)]
        self._base_slice = [bs[pi].copy() for pi in range(P)]
        self._slice_set = [bool(x) for x in ss]
        self._active = bool(np.asarray(d["active"]))
        self._load_n = self._load_l = None
        for pi, p in enumerate(self.pops):
            w = self.weights[pi]
            if self._slice_set[pi]:
                p.update_slice(self._base_slice[pi]
                               * self.step ** (-an[pi].astype(np.float64)
                                               * w))
            if (al[pi] != 0).any():
                p.update_backhaul(
                    self.step ** (-al[pi].astype(np.float64) * w))

    # -------------------------------------------------------------- loads
    def loads(self, return_groups: bool = False):
        return accumulate_loads(self.pops, return_groups=return_groups)

    def _loads_tracked(self):
        """Canonical loads, remembered as the admission screen's running
        totals (kept in sync with the current incumbent set)."""
        nl, ll = self.loads()
        self._load_n, self._load_l = nl, ll
        return nl, ll

    def _snapshot(self):
        """Per-cohort incumbent state, for the post-pass moved-user diff."""
        return [(p.inc_found.copy(), p._inc_exit.copy(),
                 p._inc_place.copy(), p._inc_energy.copy())
                for p in self.pops]

    def _note_moved(self, rep: CongestionReport, snap) -> None:
        """Record the global ids whose incumbent actually changed vs the
        pre-mutation snapshot (found flag flipped, or — for found users —
        exit, placement or energy moved)."""
        for (f0, e0, pl0, en0), p in zip(snap, self.pops):
            found = p.inc_found
            ch = (f0 != found) | (found & (
                (e0 != p._inc_exit)
                | (pl0 != p._inc_place).any(axis=1)
                | (en0 != p._inc_energy)))
            rep.moved_gids.extend(int(g) for g in p.user_ids[ch])
        rep.moved_gids.sort()

    def _note_util(self, rep: CongestionReport, node_load: np.ndarray,
                   link_load: np.ndarray) -> None:
        fn = np.isfinite(self.node_cap)
        fl = np.isfinite(self.link_cap)
        if fn.any():
            rep.max_node_util = max(rep.max_node_util, float(
                (node_load[fn] / self.node_cap[fn]).max()))
        if fl.any():
            rep.max_link_util = max(rep.max_link_util, float(
                (link_load[fl] / self.link_cap[fl]).max()))

    # --------------------------------------------------------- fixed point
    def run_tick(self) -> CongestionReport:
        """One congestion pass: the priced fixed point, then admission
        control on any residual overload, then re-admission sweeps."""
        rep = CongestionReport()
        self._degraded_tick: set = set()
        # admission may mutate even without a bump this tick (warm capped
        # prices) — snapshot up front then; otherwise lazily at the first
        # bump, so read-only probes stay zero-copy
        snap = self._snapshot() if self._active else None
        node_load, link_load = self._loads_tracked()
        rep.iterations = 1
        self._note_util(rep, node_load, link_load)
        finite = (np.isfinite(self.node_cap).any()
                  or np.isfinite(self.link_cap).any())
        if not finite:
            rep.converged = True
            return rep

        for it in range(1, self.capacity.max_iters + 1):
            rep.iterations = it
            over_n = node_load > self.node_cap
            over_l = link_load > self.link_cap
            if not over_n.any() and not over_l.any():
                rep.converged = True
                break
            bump_n = over_n & (self.node_k < self.k_max)
            bump_l = over_l & (self.link_k < self.k_max)
            if not bump_n.any() and not bump_l.any():
                rep.capped = True       # overloaded but fully priced out
                break
            if snap is None:
                snap = self._snapshot()
            self.node_k[bump_n] += 1
            self.link_k[bump_l] += 1
            rep.touched = True
            self._active = True
            rep.n_repriced += self._apply_prices()
            node_load, link_load = self._loads_tracked()
            self._note_util(rep, node_load, link_load)
        else:
            # iteration cap exhausted right after a reprice: the final
            # loads were never classified — do it here so the report
            # reflects the state actually left behind (the last bump may
            # well have cleared the overload)
            over_n = node_load > self.node_cap
            over_l = link_load > self.link_cap
            if not over_n.any() and not over_l.any():
                rep.converged = True
            elif not ((over_n & (self.node_k < self.k_max)).any()
                      or (over_l & (self.link_k < self.k_max)).any()):
                rep.capped = True

        if self._active:
            self._admission(rep, node_load, link_load)
            self._readmit(rep)
            for p in self.pops:
                rep.unplaced_ids.extend(
                    int(g) for g in p.user_ids[~p.inc_found])
            rep.unplaced_ids.sort()
        if snap is not None:
            self._note_moved(rep, snap)
        rep.n_priced_nodes = int((self.node_k > 0).sum())
        rep.n_priced_links = int((self.link_k > 0).sum())
        return rep

    # ----------------------------------------------------------- admission
    def _worst_overload(self, node_load: np.ndarray, link_load: np.ndarray):
        """The most overloaded resource, or None: max load/cap ratio,
        nodes before links and lowest (flat) index on exact ties."""
        over_n = node_load > self.node_cap
        over_l = link_load > self.link_cap
        if not over_n.any() and not over_l.any():
            return None
        rn = np.where(np.isfinite(self.node_cap),
                      node_load / self.node_cap, 0.0)
        rl = np.where(np.isfinite(self.link_cap),
                      link_load / self.link_cap, 0.0)
        best_n = float(rn.max()) if over_n.any() else -np.inf
        best_l = float(rl.max()) if over_l.any() else -np.inf
        if best_n >= best_l:
            return ("node", int(np.argmax(rn)))
        i, j = np.unravel_index(int(np.argmax(rl)), rl.shape)
        return ("link", (int(i), int(j)))

    def _largest_contributor(self, worst) -> Tuple[int, int]:
        """(pop_index, local_user) of the largest contributor to the given
        resource: max per-config load entry; largest global user id on
        ties (later arrivals yield first — deterministic either way)."""
        _nl, _ll, groups = self.loads(return_groups=True)
        kind, where = worst
        best = None                  # (contribution, gid, pop_index, local)
        for pi, _cfg, members, nrow, lrow in groups:
            c = float(nrow[where] if kind == "node" else lrow[where])
            if c <= 0.0:
                continue
            gids = self.pops[pi].user_ids[members]
            pos = int(np.argmax(gids))
            gid = int(gids[pos])
            lu = int(members[pos])
            if best is None or c > best[0] or (c == best[0]
                                               and gid > best[1]):
                best = (c, gid, pi, lu)
        assert best is not None, "overloaded resource with no contributor"
        return best[2], best[3]

    #: relative slack for the incremental admission screen: the running
    #: totals differ from the canonical grouped reduction only by
    #: summation-order rounding (~U * eps relative), so anything past
    #: this margin is overloaded under either summation — 1e-9 covers
    #: reordering error out to ~1e7 users with three orders to spare
    _SCREEN_SLACK = 1e-9

    def _screen_rejects(self, pi: int, lu: int, cfg: Config) -> bool:
        """Cheap O(N^2) pre-check for :meth:`_fits`: the candidate's own
        load delta on top of the tracked running totals.  True only when
        the install exceeds a capacity by more than the summation-order
        slack — i.e. when the canonical reduction would certainly reject
        too; borderline installs fall through to the canonical check."""
        if self._load_n is None:
            return False
        p = self.pops[pi]
        N = len(self.node_cap)
        new_n, new_l = config_load_rows(p.profile, cfg, p.req.sigma, N,
                                        p.src)
        est_n = self._load_n + new_n
        est_l = self._load_l + new_l
        if p.inc_found[lu]:
            k = int(p._inc_exit[lu])
            nb = p.profile.exits[k].block + 1
            old = Config(placement=[int(x) for x in p._inc_place[lu][:nb]],
                         final_exit=k)
            old_n, old_l = config_load_rows(p.profile, old, p.req.sigma, N,
                                            p.src)
            est_n = est_n - old_n
            est_l = est_l - old_l
        slack = 1.0 + self._SCREEN_SLACK
        return bool((est_n > self.node_cap * slack).any()
                    or (est_l > self.link_cap * slack).any())

    def _fits(self, pi: int, lu: int, cfg: Config, energy: float) -> bool:
        """Install ``cfg`` as user (pi, lu)'s incumbent iff the resulting
        FROM-SCRATCH population loads satisfy every capacity; reverts the
        incumbent otherwise.  Clear misfits are screened out first against
        an incrementally maintained load total (O(N^2), not O(U)); the
        decision itself recomputes through the canonical grouped
        reduction, keeping accepted fits IEEE-identical to the post-hoc
        oracle."""
        if self._screen_rejects(pi, lu, cfg):
            return False
        p = self.pops[pi]
        save = (p._inc_place[lu].copy(), int(p._inc_exit[lu]),
                float(p._inc_energy[lu]), bool(p._solved[lu]),
                p._solutions[lu])
        p.set_incumbents(np.array([lu]), [cfg], [energy])
        nl, ll = self.loads()
        if (nl <= self.node_cap).all() and (ll <= self.link_cap).all():
            self._load_n, self._load_l = nl, ll
            return True
        p._inc_place[lu] = save[0]
        p._inc_exit[lu] = save[1]
        p._inc_energy[lu] = save[2]
        p._solved[lu] = save[3]
        p._solutions[lu] = save[4]
        return False

    def _try_degrade(self, pi: int, lu: int) -> bool:
        """Move the victim to its cheapest frontier row (excluding the
        current incumbent) whose adoption satisfies every capacity."""
        p = self.pops[pi]
        nb = p.profile.exits[int(p._inc_exit[lu])].block + 1
        cur = (int(p._inc_exit[lu]),
               tuple(int(x) for x in p._inc_place[lu][:nb]))
        fr = p.frontier(int(lu), k_per_exit=self.frontier_k)
        for row in fr.rows:                       # energy-ascending
            key = (row.config.final_exit, tuple(row.config.placement))
            if key == cur:
                continue
            if self._fits(pi, lu, row.config, row.energy):
                return True
        return False

    def _admission(self, rep: CongestionReport, node_load: np.ndarray,
                   link_load: np.ndarray) -> None:
        """Deterministic eviction until no capacity is violated.  Each
        round either degrades a first-time victim to a fitting frontier
        row or rejects it outright, so the loop is bounded by 2U rounds;
        a resource with zero admitted contributors carries zero load, so
        termination implies zero violations."""
        while True:
            worst = self._worst_overload(node_load, link_load)
            if worst is None:
                break
            pi, lu = self._largest_contributor(worst)
            p = self.pops[pi]
            gid = int(p.user_ids[lu])
            rep.touched = True
            rep.n_evicted += 1
            done = False
            if gid not in self._degraded_tick:
                self._degraded_tick.add(gid)      # one degrade per tick
                done = self._try_degrade(pi, lu)
                if done:
                    rep.n_degraded += 1
            if not done:
                p.set_incumbents(np.array([lu]), [None], [np.inf])
                rep.n_rejected += 1
            node_load, link_load = self._loads_tracked()

    def _readmit(self, rep: CongestionReport) -> None:
        """Sweep unplaced users (ascending global id) onto their cheapest
        fitting frontier row, repeating until a pass admits no one —
        afterwards every still-unplaced user provably has no frontier row
        that fits the residual capacity at the current prices."""
        while True:
            cands: List[Tuple[int, int, int]] = []
            for pi, p in enumerate(self.pops):
                for lu in np.nonzero(~p.inc_found)[0]:
                    cands.append((int(p.user_ids[lu]), pi, int(lu)))
            cands.sort()
            admitted_any = False
            for _gid, pi, lu in cands:
                fr = self.pops[pi].frontier(lu, k_per_exit=self.frontier_k)
                for row in fr.rows:
                    if self._fits(pi, lu, row.config, row.energy):
                        admitted_any = True
                        rep.touched = True
                        rep.n_readmitted += 1
                        break
            if not admitted_any:
                break
