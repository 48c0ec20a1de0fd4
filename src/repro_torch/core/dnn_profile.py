"""Plane-2 model: DNN layer-block profiles with early exits.

A :class:`DNNProfile` captures everything the placement problem needs to know
about a dynamic DNN (Sec. II-A, Plane 2):

  * per-block compute cost ``block_ops[i]`` (ops),
  * the size of each block's output (cut-layer tensor) ``cut_bits[i]`` (bits),
  * the model input size ``input_bits``,
  * early exits: position (block index), compute cost, output size, accuracy,
    and the fraction ``phi`` of samples captured by each exit (Table II).

``phi`` semantics: ``phi[e]`` is the fraction of input samples that exit at
early-exit ``e`` when *all* exits up to the deepest deployed one are active.
If the deployed configuration stops at exit ``k``, the residual probability
mass of deeper exits collapses onto exit ``k`` (those samples are forced out).
``survival_after_block(i, k)`` gives the expected fraction of traffic that
crosses the cut after block ``i`` — this is the load-weighting term
sigma * phi of constraints (3d)-(3e) and of the objective (3a).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ExitSpec:
    """An early exit attached to a backbone block."""

    block: int          # 0-based index of the block it is attached to
    ops: float          # ops to execute the exit head
    out_bits: float     # size of the exit's output (logits), bits
    accuracy: float     # inference accuracy when the model stops here (Table IV)
    phi: float          # fraction of samples captured here (Table II)


@dataclass
class DNNProfile:
    """Plane 2: a chain of backbone blocks with early exits."""

    name: str
    input_bits: float
    block_ops: List[float]          # ops of each backbone block, len L
    cut_bits: List[float]           # bits output by each block, len L
    exits: List[ExitSpec]           # sorted by block index; last exit at block L-1

    def __post_init__(self) -> None:
        assert len(self.block_ops) == len(self.cut_bits)
        self.exits = sorted(self.exits, key=lambda e: e.block)
        assert self.exits, "a profile needs at least one (final) exit"
        assert self.exits[-1].block == self.n_blocks - 1, \
            "the deepest exit must sit on the last block"
        blocks = [e.block for e in self.exits]
        assert len(set(blocks)) == len(blocks), "at most one exit per block"
        # phi / survival accounting is pure in (block, final_exit) and sits on
        # the exact-evaluation hot path (every candidate configuration of
        # every solver calls it) — memoize per profile.  Profiles are treated
        # as immutable after construction.
        self._phi_cache: Dict[int, np.ndarray] = {}
        self._surv_cache: Dict[Tuple[int, int], float] = {}
        self._ops_cache: Dict[Tuple[int, int], float] = {}

    # -- structure ------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return len(self.block_ops)

    @property
    def n_exits(self) -> int:
        return len(self.exits)

    def exit_at(self, block: int) -> Optional[ExitSpec]:
        for e in self.exits:
            if e.block == block:
                return e
        return None

    def exit_index_at(self, block: int) -> Optional[int]:
        for k, e in enumerate(self.exits):
            if e.block == block:
                return k
        return None

    # -- phi / survival accounting ---------------------------------------------
    def effective_phi(self, final_exit: int) -> np.ndarray:
        """Exit-capture fractions when the config stops at exit ``final_exit``.

        The residual mass of suppressed deeper exits collapses onto the final
        deployed exit (those samples are forced to exit there).
        """
        assert 0 <= final_exit < self.n_exits
        cached = self._phi_cache.get(final_exit)
        if cached is None:
            phi = np.array([e.phi for e in self.exits], dtype=np.float64)
            phi = phi / phi.sum()  # normalize Table II percentages
            cached = phi[: final_exit + 1].copy()
            cached[final_exit] += phi[final_exit + 1:].sum()
            cached.flags.writeable = False   # shared across callers
            self._phi_cache[final_exit] = cached
        return cached

    def survival_after_block(self, block: int, final_exit: int) -> float:
        """Fraction of samples still in flight after block ``block``'s exit."""
        key = (block, final_exit)
        cached = self._surv_cache.get(key)
        if cached is None:
            phi = self.effective_phi(final_exit)
            gone = 0.0
            for k, e in enumerate(self.exits[: final_exit + 1]):
                if e.block <= block:
                    gone += phi[k]
            cached = max(0.0, 1.0 - gone)
            self._surv_cache[key] = cached
        return cached

    def survival_entering_block(self, block: int, final_exit: int) -> float:
        """Fraction of samples that still need to *execute* block ``block``."""
        if block == 0:
            return 1.0
        return self.survival_after_block(block - 1, final_exit)

    # -- per-config aggregate quantities ----------------------------------------
    def block_ops_with_exit(self, block: int, final_exit: int) -> float:
        """Backbone + exit-head ops executed at ``block`` (exits <= final
        only).  Memoized — it sits on the exact-evaluation hot path."""
        key = (block, final_exit)
        cached = self._ops_cache.get(key)
        if cached is None:
            cached = self.block_ops[block]
            k = self.exit_index_at(block)
            if k is not None and k <= final_exit:
                cached += self.exits[k].ops
            self._ops_cache[key] = cached
        return cached

    def accuracy_of(self, final_exit: int) -> float:
        """Config inference quality a(pi): accuracy of the deepest deployed exit."""
        return self.exits[final_exit].accuracy


# ---------------------------------------------------------------------------
# Paper models (Tables II, III, IV)
# ---------------------------------------------------------------------------

MOPS = 1e6
#: bits per feature-map element on a cut.  Split-computing systems quantize
#: activations at the cut (BottleNet/BottleFit); 8-bit makes the paper's
#: latency numbers consistent with Table V link rates (DESIGN.md Sec. 7).
BITS_PER_FEATURE = 8

# Table III: [input features, MOPs] per block; exits listed separately.
_B_ALEXNET_BLOCKS = [(290400, 0.043), (186624, 6.711), (64896, 10.145),
                     (64896, 13.523), (43264, 29.045)]
_B_ALEXNET_EXITS = [(64896, 22.579), (43264, 9.056), (1000, 0.039)]
_B_RESNET_BLOCKS = [(16384, 0.004), (16384, 0.021), (16384, 0.021),
                    (4096, 0.083), (4096, 0.664)]
_B_RESNET_EXITS = [(4096, 0.748), (4096, 0.665), (10, 0.001)]
_B_LENET_BLOCKS = [(4704, 0.118), (1600, 0.040), (120, 0.048)]
_B_LENET_EXITS = [(120, 0.05), (10, 0.022)]

# Table II: exit-capture fractions phi (percent).
_PHI = {
    "b-alexnet": [65.6, 25.2, 9.2],
    "b-resnet": [41.5, 13.8, 44.7],
    "b-lenet": [94.3, 5.63],
}
# Table IV: per-exit accuracies per application h1..h6 (percent).
_ACC = {
    "h1": [39.56, 54.22, 60.32],   # B-AlexNet / CIFAR100
    "h2": [56.37, 78.04, 85.95],   # B-AlexNet / CIFAR10
    "h3": [29.97, 39.93, 72.21],   # B-ResNet  / CIFAR100
    "h4": [38.97, 51.93, 93.91],   # B-ResNet  / CIFAR10
    "h5": [91.18, 96.70],          # B-LeNet   / MNIST
    "h6": [93.54, 99.20],          # B-LeNet   / EMNIST
}
#: Exit attachment points: AlexNet/ResNet exits after blocks 1, 3, 5 (Table VI
#: Config-2/3 places exit-1 with l1, exit-2 with l3, exit-3 with l5); B-LeNet
#: exit-1 after block 1 (BranchyNet placement) and the final exit after block 3.
_EXIT_BLOCKS = {
    "b-alexnet": [0, 2, 4],
    "b-resnet": [0, 2, 4],
    "b-lenet": [0, 2],
}
_MODEL_OF_APP = {
    "h1": "b-alexnet", "h2": "b-alexnet",
    "h3": "b-resnet", "h4": "b-resnet",
    "h5": "b-lenet", "h6": "b-lenet",
}
_INPUT_FEATURES = {
    "b-alexnet": 227 * 227 * 3,
    "b-resnet": 32 * 32 * 3,
    "b-lenet": 28 * 28 * 1,
}
_BLOCKS = {
    "b-alexnet": (_B_ALEXNET_BLOCKS, _B_ALEXNET_EXITS),
    "b-resnet": (_B_RESNET_BLOCKS, _B_RESNET_EXITS),
    "b-lenet": (_B_LENET_BLOCKS, _B_LENET_EXITS),
}


def paper_profile(app: str, *, bits_per_feature: int = BITS_PER_FEATURE) -> DNNProfile:
    """Build the DNNProfile of application h1..h6 from the paper's tables."""
    model = _MODEL_OF_APP[app]
    blocks, exits = _BLOCKS[model]
    phi = _PHI[model]
    acc = _ACC[app]
    exit_blocks = _EXIT_BLOCKS[model]
    n_blocks = len(blocks)
    # Table III "number of features" is each block's *output* feature count
    # (B-AlexNet row 1 = 55x55x96 = 290400 = conv1 output; B-LeNet row 1 =
    # 28x28x6 = 4704 = same-pad conv1 output) — so the cut after block i
    # carries exactly row i's features.
    out_features = [blocks[i][0] for i in range(n_blocks)]
    block_ops = [b[1] * MOPS for b in blocks]
    cut_bits = [f * bits_per_feature for f in out_features]
    exit_specs = [
        ExitSpec(block=exit_blocks[k], ops=exits[k][1] * MOPS,
                 out_bits=exits[k][0] * bits_per_feature,
                 accuracy=acc[k] / 100.0, phi=phi[k] / 100.0)
        for k in range(len(exits))
    ]
    return DNNProfile(
        name=f"{model}:{app}",
        input_bits=_INPUT_FEATURES[model] * bits_per_feature,
        block_ops=block_ops,
        cut_bits=cut_bits,
        exits=exit_specs,
    )


def all_paper_apps() -> Dict[str, DNNProfile]:
    return {h: paper_profile(h) for h in ("h1", "h2", "h3", "h4", "h5", "h6")}


def synthetic_profile(n_blocks: int, n_exits: int, *, seed: int = 0,
                      ops_scale: float = 10 * MOPS,
                      bits_scale: float = 1e6) -> DNNProfile:
    """Random chain profile for property-based tests and scaling benchmarks."""
    rng = np.random.default_rng(seed)
    assert 1 <= n_exits <= n_blocks
    block_ops = (rng.uniform(0.05, 1.0, n_blocks) * ops_scale).tolist()
    cut_bits = (rng.uniform(0.05, 1.0, n_blocks) * bits_scale).tolist()
    exit_blocks = sorted(rng.choice(n_blocks - 1, size=n_exits - 1,
                                    replace=False).tolist()) + [n_blocks - 1]
    accs = np.sort(rng.uniform(0.3, 0.99, n_exits))
    phis = rng.dirichlet(np.ones(n_exits))
    exits = [ExitSpec(block=int(b), ops=float(rng.uniform(0.01, 0.5) * ops_scale),
                      out_bits=float(rng.uniform(0.001, 0.01) * bits_scale),
                      accuracy=float(accs[k]), phi=float(phis[k]))
             for k, b in enumerate(exit_blocks)]
    return DNNProfile(
        name=f"synthetic-{n_blocks}b{n_exits}e-s{seed}",
        input_bits=float(rng.uniform(0.5, 2.0) * bits_scale),
        block_ops=block_ops,
        cut_bits=cut_bits,
        exits=exits,
    )
