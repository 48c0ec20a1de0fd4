"""The port's users-sharded mesh relaxer (``repro_torch.sharding``) vs the
JAX package's, and the ``mesh`` backend of ``Population`` and the
orchestrator.

Counterpart of ``tests/test_mesh_relaxer.py``, the reference's mesh
``Population`` test and the multi-process workers
``tests/multihost_worker.py`` / ``tests/dropout_worker.py``.  Meshes here
are logical CPU shards (``population_mesh(n, device="cpu")``), so the
pad-and-strip branch runs with 4 shards; each shard runs the plain version
of B1 in float32.  The reference's mesh is its one CPU device.

Run as a script (``python tests/test_torch_mesh.py <rank> <world>
<port>``) this file is one rank of the two-rank gloo test.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch


def _case(D, seed=0, L=3, N=5, Gp1=11):
    rng = np.random.default_rng(seed)
    steep = np.where(rng.random((D, L, N, N)) < 0.5,
                     rng.integers(0, Gp1 - 1, (D, L, N, N)).astype(float),
                     np.inf)
    E = rng.random((D, L, N, N))
    init = np.where(rng.random((D, N, Gp1)) < 0.3,
                    rng.random((D, N, Gp1)), np.inf)
    return init, E, steep


def _worker(rank, world, port):
    """One rank: a ragged shard through the two-rank mesh equals a local
    relaxer; a symmetric stall schedule demotes once and stays exact; the
    orchestrator's relax times are gathered over the ranks."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.core.faults import FaultPlan
        from repro_torch.core.online import (ChurnOrchestrator, TickReport,
                                             population_cohorts)
        from repro_torch.sharding.population import (MeshRelaxer,
                                                     PopulationMesh,
                                                     population_mesh)
        cpu2 = (torch.device("cpu"),) * 2
        mr = MeshRelaxer(population_mesh(2, device="cpu"))
        assert mr.multihost and mr.n_devices == 2 * world, mr.n_devices
        D = 3 + 2 * rank                  # ragged: ranks disagree on size
        init, E, steep = _case(D, seed=42 + rank, Gp1=11)
        hist, par = mr.relax(init, E, steep, None)
        assert hist.shape == (D, 4, 5, 11) and par.shape == (D, 3, 5, 11)
        hl, pl = MeshRelaxer(PopulationMesh(cpu2)).relax(init, E, steep,
                                                         None)
        assert np.array_equal(hist, hl) and np.array_equal(par, pl)
        print(f"rank {rank}: D={D} global==local exact", flush=True)

        # fail every attempt at the multi-rank rung (max_retries=1 -> 2
        # attempts) on both ranks: one rung down, then exact
        mr = MeshRelaxer(population_mesh(2, device="cpu"), max_retries=1,
                         backoff_s=0.0, timeout_s=60.0)
        mr.fault_hook = FaultPlan.stall_hook(2)
        init, E, steep = _case(D, seed=17 + rank)
        hist, par = mr.relax(init, E, steep, None)
        assert (mr.demotions, mr.retries) == (1, 1), (mr.demotions,
                                                      mr.retries)
        assert not mr.multihost and mr.n_devices == 2
        hc, pc = MeshRelaxer(PopulationMesh(cpu2)).relax(init, E, steep,
                                                         None)
        assert np.array_equal(hist, hc) and np.array_equal(par, pc)
        print(f"rank {rank}: D={D} demoted, post-demotion exact", flush=True)

        # the straggler detector's times: every rank sees every rank's
        o = ChurnOrchestrator(population=population_cohorts(
            6, n_extra_edge=1, gamma=8, device="cpu"))
        o.pops[0]._mesh_relaxer = MeshRelaxer(population_mesh(
            1, device="cpu"), timeout_s=60.0)
        times = o._gather_relax_times(TickReport(tick=0,
                                                 t_relax_ms=1.0 + rank))
        assert times.tolist() == [1.0 + r for r in range(world)], times
        print(f"rank {rank}: relax times gathered {times.tolist()}",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


import pytest  # noqa: E402

from repro.core.bellman_ford import batched_banded_relax_minarg  # noqa: E402
import repro.core as R  # noqa: E402
from repro.core.faults import FaultPlan as RefFaultPlan  # noqa: E402
from repro.core.multiapp import PAPER_MULTIAPP_REQS  # noqa: E402
from repro.core.scenarios import paper_scenario  # noqa: E402
from repro.sharding.population import MeshRelaxer as RefMesh  # noqa: E402
from repro.runtime.straggler import StragglerDetector as RefDet  # noqa: E402

import repro_torch as T  # noqa: E402
import repro_torch.sharding.population as SP  # noqa: E402
from repro_torch.convert import (network_from, profile_from,  # noqa: E402
                                 requirements_from)
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.tolerances import RELAX_RTOL_F32  # noqa: E402
from repro_torch.runtime.straggler import StragglerDetector  # noqa: E402
from repro_torch.sharding import (MeshRelaxer, PopulationMesh,  # noqa: E402
                                  population_mesh)

from test_torch_online import assert_reports  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
SHARDS = [1, 4]


def _mesh(n, **kw):
    return MeshRelaxer(population_mesh(n, device=CPU), **kw)


def _check(mr, D, seed=0):
    init, E, steep = _case(D, seed)
    h, p = mr.relax(init, E, steep, None)
    assert h.shape == (D, 4, 5, 11) and h.dtype == np.float64
    assert p.shape == (D, 3, 5, 11) and p.dtype == np.int64
    h64, _ = batched_banded_relax_minarg(
        init, np.where(np.isfinite(steep), E, np.inf), steep, None)
    fin = np.isfinite(h64)
    assert np.array_equal(np.isfinite(h), fin)
    np.testing.assert_allclose(h[fin], h64[fin], rtol=RELAX_RTOL_F32)
    assert h[:, 0].tobytes() == init.tobytes()      # exact f64 init row
    return h, p


@pytest.mark.parametrize("n", SHARDS)
def test_divisible_counts_no_padding(n):
    mr = _mesh(n)
    assert mr.n_devices == n and not mr.multihost
    _check(mr, 2 * n, seed=1)
    _check(mr, 8, seed=99)


@pytest.mark.parametrize("n", SHARDS)
def test_ragged_counts_pad_and_strip(n):
    mr = _mesh(n)
    for D in (1, n + 1, 3 * n - 1, 5, 7):
        _check(mr, D, seed=10 + D)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("D", [1, 3, 6, 9])
def test_agrees_with_reference_mesh(n, D):
    """Identical finite masks and parents, hist within RELAX_RTOL_F32, and
    the same exact float64 init row, against the reference's relaxer."""
    init, E, steep = _case(D, seed=100 + D)
    h, p = _mesh(n).relax(init, E, steep, None)
    hr, pr = RefMesh().relax(init, E, steep, None)
    fin = np.isfinite(hr)
    assert np.array_equal(np.isfinite(h), fin)
    assert np.array_equal(p, pr) and p.dtype == pr.dtype
    np.testing.assert_allclose(h[fin], hr[fin], rtol=RELAX_RTOL_F32)
    assert h[:, 0].tobytes() == hr[:, 0].tobytes()


def test_tensor_inputs_and_window():
    """Tensor inputs (an expanded E, as the cohort passes it) and a depth
    window give what numpy inputs give."""
    init, E, steep = _case(5, seed=3)
    E1 = E[:1]
    Eb = np.broadcast_to(E1, E.shape)
    a = _mesh(4).relax(init, Eb, steep, 2)
    b = _mesh(4).relax(torch.from_numpy(init),
                       torch.from_numpy(E1).expand(E.shape),
                       torch.from_numpy(steep), 2)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    r = RefMesh().relax(init, Eb, steep, 2)
    assert np.array_equal(a[1], r[1])


def test_malformed_stacks_raise():
    mr = _mesh(4)
    init, E, steep = _case(4)
    with pytest.raises(ValueError, match="init must be"):
        mr.relax(init[:, 0], E, steep, None)
    with pytest.raises(ValueError, match="E/steep"):
        mr.relax(init, E[:, :, :4], steep, None)
    with pytest.raises(ValueError, match="E/steep"):
        mr.relax(init, E, steep[:2], None)
    with pytest.raises(ValueError, match="E/steep"):
        mr.relax(init, E[:2], steep[:2], None)


def test_zero_layer_chain_short_circuits():
    mr = _mesh(4)
    init, _, _ = _case(3)
    h, p = mr.relax(init, np.empty((3, 0, 5, 5)), np.empty((3, 0, 5, 5)),
                    None)
    assert np.array_equal(h[:, 0], init) and p.shape == (3, 0, 5, 11)


def test_population_mesh_validation():
    with pytest.raises(ValueError, match=">= 1"):
        population_mesh(0, device=CPU)
    with pytest.raises(ValueError, match="logical shards"):
        population_mesh(2, device="cuda:0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            population_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            MeshRelaxer()
    else:
        with pytest.raises(ValueError, match="visible"):
            population_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="devices"):
        MeshRelaxer(PopulationMesh(()))
    m = population_mesh(3, device=CPU)
    assert m.devices == (torch.device("cpu"),) * 3 and m.size == 3


# ---------------------------------------------------------------------------
# the retry / demotion ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2])
def test_retry_within_budget_no_demotion(n):
    init, E, steep = _case(3, seed=21)
    hc, pc = _mesh(4).relax(init, E, steep, None)
    for mod_plan, rx in ((RefFaultPlan, RefMesh(max_retries=2,
                                                backoff_s=0.0)),
                         (FaultPlan, _mesh(4, max_retries=2,
                                           backoff_s=0.0))):
        rx.fault_hook = mod_plan.stall_hook(n)
        h, p = rx.relax(init, E, steep, None)
        assert rx.retries == n and rx.demotions == 0
    assert np.array_equal(h, hc) and np.array_equal(p, pc)


def test_retry_budget_spent_demotes_bit_exact():
    mr = _mesh(4, max_retries=0, backoff_s=0.0)
    init, E, steep = _case(5, seed=22)
    hc, pc = _mesh(4).relax(init, E, steep, None)
    mr.fault_hook = FaultPlan.stall_hook(1)   # kill the only attempt
    h, p = mr.relax(init, E, steep, None)
    assert mr.demotions == 1 and mr.n_devices == 1
    assert np.array_equal(h, hc) and np.array_equal(p, pc)
    init2, E2, steep2 = _case(2, seed=23)     # usable on the demoted rung
    h2, _ = mr.relax(init2, E2, steep2, None)
    assert np.array_equal(h2, _mesh(4).relax(init2, E2, steep2, None)[0])


@pytest.mark.parametrize("n", SHARDS)
def test_bottom_of_ladder_reraises(n):
    mr = _mesh(n, max_retries=1, backoff_s=0.0)
    init, E, steep = _case(2, seed=24)
    mr.fault_hook = FaultPlan.stall_hook(10 ** 6)   # never heals
    with pytest.raises(TimeoutError, match="injected host stall"):
        mr.relax(init, E, steep, None)
    assert mr.n_devices == 1
    assert mr.demotions == (1 if n > 1 else 0)
    assert mr.retries == 1 + (n > 1)        # max_retries a rung


def test_nonrecoverable_errors_are_not_retried():
    mr = _mesh(4, max_retries=3, backoff_s=0.0)
    init, E, steep = _case(2, seed=25)

    def bomb(attempt):
        raise KeyError("not in RECOVERABLE")

    mr.fault_hook = bomb
    with pytest.raises(KeyError):
        mr.relax(init, E, steep, None)
    assert mr.retries == 0 and mr.demotions == 0


def test_kernel_errors_propagate_without_retry(monkeypatch):
    """A failure of the relaxation itself (a CUDA launch error is a
    RuntimeError) is not a stall: no retry, no demotion."""
    mr = _mesh(4, max_retries=3, backoff_s=0.0)
    init, E, steep = _case(2, seed=26)

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(SP, "batched_banded_relax_argmin", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        mr.relax(init, E, steep, None)
    assert (mr.retries, mr.demotions, mr.n_devices) == (0, 0, 4)


# ---------------------------------------------------------------------------
# Population(backend="mesh") and the orchestrator
# ---------------------------------------------------------------------------

def _counters(p):
    return {k: v for k, v in p.stats.__dict__.items()
            if not k.startswith("t_")}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("app", ["h1", "h4"])
def test_mesh_population_twins_reference(app, n):
    """Twin mesh cohorts (the reference's on its one CPU device, the port's
    on n logical shards): identical change flags, Solutions and counters
    through 4 ticks, and the port's equal to its ``f32`` cohort."""
    nw = paper_scenario(n_extra_edge=2)
    pf, req = R.paper_profile(app), PAPER_MULTIAPP_REQS[app]
    args = (network_from(nw), profile_from(pf),
            requirements_from(req.alpha, req.delta, req.sigma), 24)
    ref = R.Population(nw, pf, req, 24, backend="mesh",
                       fused_ingest="numpy")
    got = T.Population(*args, backend="mesh", device=CPU)
    got._mesh_relaxer = _mesh(n)
    f32 = T.Population(*args, backend="f32", device=CPU)
    rng = np.random.default_rng(n)
    for t in range(4):
        q = rng.uniform(0.2, 2.0, 24) * 1e9
        ch = ref.ingest(q), got.ingest(q), f32.ingest(q)
        assert ch[0].tobytes() == ch[1].tobytes() == ch[2].tobytes(), t
        for a, b, c in zip(ref.solve(), got.solve(), f32.solve()):
            assert a.found == b.found == c.found, t
            if a.found:
                for x in (b, c):
                    assert a.config.placement == x.config.placement, t
                    assert a.config.final_exit == x.config.final_exit, t
                    assert a.energy == x.energy, t
        assert _counters(got) == _counters(ref), t
        assert got.n_states == ref.n_states
    assert got._mesh_relaxer.retries == 0
    assert got.stats.bounded_relaxes == 0       # off for the mesh
    assert np.array_equal(ref.inc_found, got.inc_found)


def _orchs(**kw):
    a = R.ChurnOrchestrator(population=R.population_cohorts(
        18, n_extra_edge=1, gamma=8, backend="mesh", fused_ingest="numpy"),
        **kw)
    b = T.ChurnOrchestrator(population=T.population_cohorts(
        18, n_extra_edge=1, gamma=8, backend="mesh", device=CPU), **kw)
    return a, b


def _trace(T_=6, seed=9):
    rng = np.random.default_rng(seed)
    return 0.3 + 0.7 * rng.random((T_, 18))


@pytest.mark.parametrize("stream", [True, False])
def test_mesh_orchestrator_stragglers_and_stalls_twin(stream):
    """Twin mesh orchestrators with injected straggler times and the same
    stall schedule on every cohort relaxer: equal reports, including
    ``n_stragglers``, ``n_mesh_retries`` and ``n_mesh_demotions``."""
    ro, po = _orchs()
    ro._straggler_cfg = RefDet(n_workers=3, warmup=1)
    po._straggler_cfg = StragglerDetector(n_workers=3, warmup=1)

    def times(rep):
        return np.asarray([1.0, 1.0, 8.0])

    ro.straggler_times = po.straggler_times = times
    assert len(ro._relaxers()) == len(po._relaxers()) == len(po.pops)
    for rx in ro._relaxers() + po._relaxers():
        rx.backoff_s = 0.0
    for a, b in zip(ro._relaxers(), po._relaxers()):
        a.fault_hook = RefFaultPlan.stall_hook(1)
        b.fault_hook = FaultPlan.stall_hook(1)
    Q = _trace()
    ra, rb = ro.run_arrays(Q, stream=stream), po.run_arrays(Q, stream=stream)
    assert_reports(ra, rb)
    assert sum(r.n_mesh_retries for r in rb) > 0
    assert any(r.n_stragglers for r in rb)
    for p, q in zip(ro.pops, po.pops):
        assert p._inc_place.tobytes() == q._inc_place.tobytes()
        assert p._inc_energy.tobytes() == q._inc_energy.tobytes()


def test_straggler_demotes_sharded_relaxers_bit_exact():
    """On 4-shard cohort relaxers a straggler flag demotes each one rung,
    once; the reports are those of an undisturbed mesh run apart from the
    straggler and demotion counts."""
    base, po = (T.ChurnOrchestrator(population=T.population_cohorts(
        18, n_extra_edge=1, gamma=8, backend="mesh", device=CPU))
        for _ in range(2))
    for p in po.pops:
        p._mesh_relaxer = _mesh(4)
    po._straggler_cfg = StragglerDetector(n_workers=2, warmup=1)
    po.straggler_times = lambda rep: np.asarray([1.0, 9.0])
    Q = _trace(seed=4)
    ra, rb = base.run_arrays(Q), po.run_arrays(Q)
    assert sum(r.n_mesh_demotions for r in rb) == len(po.pops)
    assert all(rx.n_devices == 1 for rx in po._relaxers())
    drop = ("n_stragglers", "n_mesh_demotions")
    for a, b in zip(ra, rb):
        da = {k: v for k, v in vars(a).items()
              if not k.startswith("t_") and k not in drop}
        db = {k: v for k, v in vars(b).items()
              if not k.startswith("t_") and k not in drop}
        assert da == db, a.tick


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def test_two_rank_gloo_mesh_ragged_and_dropout():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2",
                               str(port)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, out) in enumerate(outs):
        tail = "\n".join(out.splitlines()[-20:])
        assert rc == 0, f"rank {r} failed:\n{tail}"
        assert f"rank {r}: D={3 + 2 * r} global==local exact" in out
        assert "post-demotion exact" in out
        assert "relax times gathered [1.0, 2.0]" in out
