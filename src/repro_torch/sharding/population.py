"""Device-mesh execution layer for population-scale banded relaxations.

Port of ``repro/sharding/population.py``.  The population engine's per-tick
DP work is a stack of independent banded relaxation chains — one
(L-1, N, G+1) chain per dirty cohort state.  That is embarrassingly
data-parallel over the leading axis, so the mesh layer shards it over a
``"users"`` axis of devices: the stacked (D, L-1, N, N) tensors are cut
into equal row blocks, and each block is ONE float32 launch of the banded
argmin chain (kernel B1, ``bellman_ford.batched_banded_relax_argmin``) on
its own device.  The banded DP has no cross-scenario term, so the shards
never talk to each other.

A mesh (:class:`PopulationMesh`) is a list of devices: by default every
visible CUDA device; ``population_mesh(n, device="cpu")`` gives n logical
CPU shards (each runs B1's plain version), the counterpart of the
reference's ``--xla_force_host_platform_device_count`` host devices.  Like
the reference's mesh engine, it relaxes in float32 — ``Population`` widens
its exit-prune guard accordingly (``tolerances.DIST_RTOL_F32``); the
float64 ``minplus`` backend remains the bit-exact reference.

Multi-process: when a ``torch.distributed`` process group is initialized,
``population_mesh()`` spans every rank, and every rank keeps its OWN
(ragged) user shard on its own devices.  Ranks agree on a uniform row count
a device (the most any rank needs) through one tiny allgather of the shard
sizes a relax — the only collective, run over gloo on host tensors (only
one int64 a rank crosses, and gloo, unlike NCCL, takes several ranks on
one card) — pad their local stacks to it with empty (all-inf) chains, and
relax them locally.  Nothing else crosses ranks.

Fault tolerance: the collective runs under an optional watchdog
(``timeout_s``) with bounded retries and exponential backoff; a rung whose
retries are spent takes one step down the demotion ladder (all ranks ->
this rank's devices -> one device -> raise).  Only the collective and the
``fault_hook`` test seam are retried: an error out of the kernel launch
propagates at once (a CUDA launch error is a ``RuntimeError`` too, and
retrying it on fewer devices would hide it).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.bellman_ford import batched_banded_relax_argmin

__all__ = ["PopulationMesh", "population_mesh", "MeshRelaxer"]

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclass(frozen=True)
class PopulationMesh:
    """A 1-D ``"users"`` mesh.

    ``devices`` are this process's shards, in order (a device may repeat:
    logical CPU shards).  ``rank_devices`` holds every rank's shard count
    when the mesh spans the ranks of a ``torch.distributed`` group (empty
    for a single-process mesh); ``group`` is the gloo group of the count
    allgather (None: the default group)."""

    devices: Tuple[torch.device, ...]
    rank_devices: Tuple[int, ...] = ()
    group: object = None

    @property
    def multihost(self) -> bool:
        return len(self.rank_devices) > 1

    @property
    def size(self) -> int:
        return (int(sum(self.rank_devices)) if self.multihost
                else len(self.devices))


def _distributed() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _gloo_group():
    """The group of the count allgather: the default group when it is gloo,
    else a gloo group over the same ranks (a collective call: every rank
    builds its mesh together)."""
    return None if dist.get_backend() == "gloo" \
        else dist.new_group(backend="gloo")


def _allgather(value: float, dtype: torch.dtype, group) -> np.ndarray:
    """One scalar from every rank, as a host array in rank order."""
    t = torch.tensor([value], dtype=dtype)
    out = [torch.zeros_like(t)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out).numpy()


def population_mesh(n_devices: Optional[int] = None, *,
                    device: Union[str, torch.device, None] = None
                    ) -> PopulationMesh:
    """1-D mesh over the ``"users"`` axis.

    ``device=None`` (or ``"cuda"``): every visible CUDA device, raising
    without a card; ``n_devices`` trims them.  ``device="cpu"``:
    ``n_devices`` (default 1) logical CPU shards.  When a
    ``torch.distributed`` group is initialized the mesh spans every rank,
    each contributing its own devices (CUDA devices cannot be trimmed
    then)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    elif dev == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "population_mesh: no CUDA device is visible "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "for logical CPU shards")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if _distributed():
                raise ValueError(
                    "n_devices cannot be trimmed on a multi-process mesh — "
                    "every process's devices must participate")
            if n_devices > len(devs):
                raise ValueError(f"requested {n_devices} devices but only "
                                 f"{len(devs)} are visible")
            devs = devs[:n_devices]
    else:
        raise ValueError(f"a mesh spans 'cuda' (every visible card) or "
                         f"'cpu' (logical shards), got {dev}")
    if not _distributed():
        return PopulationMesh(tuple(devs))
    group = _gloo_group()
    counts = _allgather(len(devs), torch.int64, group)
    return PopulationMesh(tuple(devs), tuple(int(c) for c in counts), group)


class _RungFailed(Exception):
    """A mesh rung spent its retries; ``error`` is the last failure."""

    def __init__(self, error: BaseException):
        super().__init__(str(error))
        self.error = error


def _host(x: ArrayLike) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tensor(x: ArrayLike) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MeshRelaxer:
    """Sharded chained banded relaxation over a ``"users"`` mesh axis.

    ``relax`` has the ``bellman_ford.batched_banded_relax_argmin``
    contract with the reference mesh's outputs: init (D, N, G+1), E/steep
    (D, L, N, N) (numpy arrays or tensors on any device) -> (hist
    (D, L+1, N, G+1) float64 with row 0 the exact float64 init, par
    (D, L, N, G+1) int64) on the host.  D is padded to a multiple of the
    shard count with empty (all-inf) chains, stripped from the outputs;
    each shard is one float32 B1 launch on its device.  The shard results
    come to the host once a relax; ``h2d_bytes`` / ``d2h_bytes`` count
    what crossed between the host and a card.
    """

    #: failures of the count collective and of the ``fault_hook`` that the
    #: retry/demotion ladder absorbs: simulated and real collective
    #: timeouts, socket-level losses of a rank and gloo's runtime errors.
    #: The kernel launch is outside the retried region.
    RECOVERABLE = (TimeoutError, OSError, RuntimeError)

    def __init__(self, mesh: Optional[PopulationMesh] = None, *,
                 timeout_s: Optional[float] = None, max_retries: int = 2,
                 backoff_s: float = 0.25):
        self._build(mesh if mesh is not None else population_mesh())
        #: per-collective timeout (None = wait forever; a rank that died
        #: otherwise blocks ``run_arrays`` for good)
        self.timeout_s = timeout_s
        #: bounded retries per mesh rung, with exponential backoff
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        #: test seam: called with the attempt index before every dispatch
        #: (``FaultPlan.stall_hook`` raises simulated stalls through it)
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.retries = 0             # dispatch attempts beyond the first
        self.demotions = 0           # mesh-ladder rungs taken
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def _build(self, mesh: PopulationMesh) -> None:
        if not mesh.devices:
            raise ValueError("a mesh needs devices on this process — every "
                             "participating process must contribute some")
        self.mesh = mesh
        #: the mesh spans several ranks: each relaxes its own shard after
        #: the count allgather
        self.multihost = mesh.multihost
        self._n_local = len(mesh.devices)

    def demote(self) -> bool:
        """Take one rung down the mesh demotion ladder.

        multi-rank mesh -> this rank's devices; several local devices -> the
        first one.  Returns False at the bottom (nothing left to shed).
        Per-scenario chains are shard-independent, so results at every
        rung are bit-exact with the full mesh — demotion sheds capacity,
        never accuracy.  On a multi-rank mesh every surviving rank must
        demote symmetrically (the straggler vector is allgathered for
        exactly this reason) or the survivors hang in the next collective.
        """
        if self.multihost:
            self._build(PopulationMesh(self.mesh.devices))
        elif self.n_devices > 1:
            self._build(PopulationMesh(self.mesh.devices[:1]))
        else:
            return False
        self.demotions += 1
        return True

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def allgather(self, value: float) -> np.ndarray:
        """One float from every rank of a multi-rank mesh, in rank order,
        over the mesh's gloo group (the straggler detector's times)."""
        return _allgather(value, torch.float64, self.mesh.group)

    def relax(self, init: ArrayLike, E: ArrayLike, steep: ArrayLike,
              lo: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
        if init.ndim != 3:
            raise ValueError(f"init must be (D, N, G+1), got "
                             f"{tuple(init.shape)}")
        D, N, Gp1 = (int(s) for s in init.shape)
        if E.ndim != 4 or E.shape[0] != D or tuple(E.shape[2:]) != (N, N) \
                or tuple(steep.shape) != tuple(E.shape):
            raise ValueError(
                f"E/steep must be ({D}, L, {N}, {N}) matching init "
                f"{tuple(init.shape)}, got E {tuple(E.shape)}, steep "
                f"{tuple(steep.shape)}")
        L = int(E.shape[1])
        init64 = _host(init).astype(np.float64)
        if isinstance(init, torch.Tensor) and init.device.type != "cpu":
            self.d2h_bytes += _nbytes(init)
        if L == 0:
            return (init64[:, None].copy(),
                    np.zeros((D, 0, N, Gp1), dtype=np.int64))
        while True:
            try:
                rows = self._dispatch(D)
                break
            except _RungFailed as f:
                # the retry budget at this rung is spent: shed capacity
                # and try the smaller mesh (bit-exact per-scenario), or
                # give up at the bottom of the ladder
                if not self.demote():
                    raise f.error from None
        hist, par = self._relax_shards(init, E, steep, lo, D, rows)
        # layer-0 history: the exact float64 init (callers read hist[0]
        # as the untouched init grid)
        hist[:, 0] = init64
        return hist, par

    def _dispatch(self, D: int) -> int:
        """One mesh rung's fault hook and shard-size agreement, with bounded
        retry + backoff; the rows each device relaxes."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.retries += 1
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                if self.fault_hook is not None:
                    self.fault_hook(attempt)
                return self._rows(D)
            except self.RECOVERABLE as e:
                last = e
        raise _RungFailed(last)

    def _rows(self, D: int) -> int:
        if not self.multihost:
            return -(-D // self._n_local)
        counts = self._collective(D)
        return max(1, int(-(-int(counts.max()) // self._n_local)))

    def _collective(self, D: int) -> np.ndarray:
        """Every rank's shard size (the one allgather of a relax), under the
        watchdog when ``timeout_s`` is set: a fresh single-use thread per
        dispatch, so a hung collective cannot poison a shared pool."""
        group = self.mesh.group
        if self.timeout_s is None:
            return _allgather(D, torch.int64, group)
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="mesh-relax")
        try:
            fut = pool.submit(_allgather, D, torch.int64, group)
            try:
                return fut.result(timeout=self.timeout_s)
            except FutTimeout:
                raise TimeoutError(
                    f"mesh collective exceeded {self.timeout_s}s "
                    f"(suspected dead or straggling rank)") from None
        finally:
            pool.shutdown(wait=False)

    def _relax_shards(self, init: ArrayLike, E: ArrayLike, steep: ArrayLike,
                      lo: Optional[int], D: int, rows: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad to ``rows`` a device, launch one B1 chain a shard (every
        launch before the first copy back, so the cards run together),
        then bring the shards to the host and strip the padding."""
        N, Gp1 = int(init.shape[1]), int(init.shape[2])
        L = int(E.shape[1])
        if rows == 0:
            return (np.zeros((0, L + 1, N, Gp1)),
                    np.zeros((0, L, N, Gp1), dtype=np.int64))
        x0, x1, x2 = _tensor(init), _tensor(E), _tensor(steep)
        pad = rows * self._n_local - D
        if pad:
            inf = float("inf")
            x0 = torch.cat([x0, x0.new_full((pad, N, Gp1), inf)])
            x1 = torch.cat([x1, x1.new_full((pad, L, N, N), inf)])
            x2 = torch.cat([x2, x2.new_full((pad, L, N, N), inf)])
        outs = []
        for i, dev in enumerate(self.mesh.devices):
            sl = slice(i * rows, (i + 1) * rows)
            shard = []
            for x in (x0, x1, x2):
                y = x[sl]
                if y.device != dev:
                    if dev.type != "cpu" and y.device.type == "cpu":
                        self.h2d_bytes += _nbytes(y)
                    y = y.to(dev)
                shard.append(y)
            outs.append(batched_banded_relax_argmin(*shard, lo,
                                                    dtype=torch.float32))
        hists, pars = [], []
        for h, p in outs:
            if h.device.type != "cpu":
                self.d2h_bytes += _nbytes(h) + _nbytes(p)
            hists.append(h.cpu().numpy())
            pars.append(p.cpu().numpy())
        hist = np.concatenate(hists)[:D].astype(np.float64)
        par = np.concatenate(pars)[:D].astype(np.int64)
        return hist, par
