"""Crash-consistent serving in the port: checkpoint / restore / resume of
``ChurnOrchestrator`` against the uninterrupted run and the reference.

Counterpart of ``tests/test_checkpoint_resume.py`` and the SIGKILL test of
``tests/test_faults_subprocess.py``.  The oracle everywhere is
bit-exactness: a run that is crashed (``FaultPlan.crash_hook``) or killed
(a real ``SIGKILL``) and resumed from its newest checkpoint must give the
same ``TickReport``s (the ``t_*`` timings left out) and incumbents as the
same run left uninterrupted, in plain, congestion-coupled and
contingency-armed modes, streamed and synchronous.  A checkpoint written by
the reference's orchestrator and resumed by the port's gives the
reference's tail, and the reverse.

Run as a script (``python tests/test_torch_resume.py <dir>``) this file is
the SIGKILL worker: it runs the shared scenario with boundary checkpoints
and kills itself at tick ``KILL_TICK``.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np

T, U, SEED = 12, 24, 7
KILL_TICK = 6
CPU = "cpu"


def _trace():
    rng = np.random.default_rng(SEED)
    Q = 0.4 + 0.6 * rng.random((T, U))
    A = rng.integers(0, 3, size=(T, U))
    return Q, A


def build(mode="plain", ref=False):
    """The shared scenario's orchestrator: the port's on the CPU, or with
    ``ref`` the reference's (numpy ingest)."""
    if ref:
        from repro.core.capacity import SharedCapacity
        from repro.core.online import ChurnOrchestrator, population_cohorts
        pops = population_cohorts(U, n_extra_edge=1, gamma=8,
                                  fused_ingest="numpy")
    else:
        from repro_torch.core.capacity import SharedCapacity
        from repro_torch.core.online import (ChurnOrchestrator,
                                             population_cohorts)
        pops = population_cohorts(U, n_extra_edge=1, gamma=8, device=CPU)
    kw = {}
    if mode == "congestion":
        N = pops[0].N
        nc = np.full(N, np.inf)
        lc = np.full((N, N), np.inf)
        nc[2] = 120.0                    # one contended edge helper
        kw["shared_capacity"] = SharedCapacity(node_cap=nc, link_cap=lc)
    if mode == "contingency":
        kw["contingency"] = True
    return ChurnOrchestrator(population=pops, hysteresis=0.05, **kw)


class KillSelf:
    """Duck-typed FaultPlan: SIGKILL instead of raising InjectedCrash."""

    def crash_hook(self, stage, tick):
        if stage == "ingest" and tick == KILL_TICK:
            print(f"worker: SIGKILL at tick {tick}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)


if __name__ == "__main__":
    Q, A = _trace()
    build().run_arrays(Q, A, checkpoint_dir=sys.argv[1], checkpoint_every=3,
                       fault_plan=KillSelf())
    print("worker: survived past the kill tick", flush=True)
    sys.exit(3)        # reaching here means the kill never fired


import pytest  # noqa: E402

from repro.runtime import checkpoint as rck  # noqa: E402

from repro_torch.core.faults import (FaultPlan, FaultSpec,  # noqa: E402
                                     InjectedCrash)
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402

MODES = ["plain", "congestion", "contingency"]
REPO = pathlib.Path(__file__).resolve().parents[1]


def rep(r):
    return {k: v for k, v in dataclasses.asdict(r).items()
            if not k.startswith("t_")}


def assert_reports_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        assert rep(ra) == rep(rb), (ra.tick, rep(ra), rep(rb))


def snap_incumbents(o):
    return [(p.inc_found.copy(), p._inc_exit.copy(), p._inc_place.copy(),
             p._inc_energy.copy()) for p in o.pops]


def assert_inc_equal(sa, sb):
    for a, b in zip(sa, sb):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def assert_state_equal(oa, ob):
    """Equal orchestrator ledgers and byte-equal cohort state_dicts."""
    for f in ("quality", "attached", "_ref_energy", "_cur_energy"):
        assert getattr(oa, f).tobytes() == getattr(ob, f).tobytes(), f
    for p, q in zip(oa.pops, ob.pops):
        a, b = p.state_dict(), q.state_dict()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


_CLEAN = {}


def clean(mode="plain"):
    """The uninterrupted run of a mode (reports, orchestrator), once."""
    if mode not in _CLEAN:
        Q, A = _trace()
        o = build(mode)
        _CLEAN[mode] = (o.run_arrays(Q, A), o)
    return _CLEAN[mode]


# ---------------------------------------------------------------------------
# kill-free oracle: save at boundaries, resume in a FRESH orchestrator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_resume_is_bit_identical(mode, tmp_path):
    Q, A = _trace()
    r1, o1 = clean(mode)
    d = str(tmp_path / "ck")
    o2 = build(mode)
    r2a = o2.run_arrays(Q[:7], A[:7], checkpoint_dir=d, checkpoint_every=4)
    o3 = build(mode)
    r2b = o3.resume(d, Q, A)            # restores trace_pos=7 (final save)
    assert len(r2a) + len(r2b) == T
    assert_reports_equal(r1, r2a + r2b)
    assert_inc_equal(snap_incumbents(o1), snap_incumbents(o3))
    assert_state_equal(o1, o3)
    # the reference's uninterrupted run gives the same reports
    assert_reports_equal(build(mode, ref=True).run_arrays(Q, A), r2a + r2b)


@pytest.mark.parametrize("mode", MODES)
def test_mid_boundary_restore(mode, tmp_path):
    Q, A = _trace()
    r1, o1 = clean(mode)
    d = str(tmp_path / "ck")
    build(mode).run_arrays(Q[:7], A[:7], checkpoint_dir=d,
                           checkpoint_every=4)
    steps = ckpt.available_steps(d)
    assert len(steps) >= 2              # boundary save + final save
    o4 = build(mode)
    pos = o4.restore(d, step=steps[0])
    assert pos == 4
    r3 = o4.run_arrays(Q[pos:], A[pos:], _trace_offset=pos)
    assert_reports_equal(r1[pos:], r3)
    assert_inc_equal(snap_incumbents(o1), snap_incumbents(o4))


@pytest.mark.parametrize("stream", [True, False])
def test_checkpoint_off_run_unchanged(stream, tmp_path):
    Q, A = _trace()
    r_off = build().run_arrays(Q, A, stream=stream)
    r_on = build().run_arrays(Q, A, stream=stream,
                              checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=5)
    assert_reports_equal(r_off, r_on)


# ---------------------------------------------------------------------------
# injected crashes at every pipeline stage, then resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("stage", ["ingest", "relax", "post"])
def test_crash_and_resume_every_stage(stage, stream, tmp_path):
    Q, A = _trace()
    r_clean, o_clean = clean()
    plan = FaultPlan(specs=[FaultSpec(kind="crash", tick=6, stage=stage)])
    d = str(tmp_path / "ck")
    o = build()
    with pytest.raises(InjectedCrash, match="tick 6"):
        o.run_arrays(Q, A, stream=stream, checkpoint_dir=d,
                     checkpoint_every=3, fault_plan=plan)
    o2 = build()
    tail = o2.resume(d, Q, A, stream=stream)   # plan not passed: cleared
    pos = T - len(tail)
    assert pos in (3, 6)                # last boundary before the crash
    assert_reports_equal(r_clean[pos:], tail)
    assert_state_equal(o_clean, o2)


def test_resume_keeps_checkpointing_on_absolute_boundaries(tmp_path):
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build().run_arrays(Q[:5], A[:5], checkpoint_dir=d, checkpoint_every=4,
                       checkpoint_keep=10)
    tail = build().resume(d, Q, A, checkpoint_every=4, checkpoint_keep=10)
    assert len(tail) == T - 5
    poss = [json.loads((pathlib.Path(d) / f"step_{s:012d}" / ckpt.MANIFEST)
                       .read_text())["extra"]["trace_pos"]
            for s in ckpt.available_steps(d)]
    assert poss == [4, 5, 8, T]


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def test_checkpoint_every_requires_dir():
    Q, A = _trace()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        build().run_arrays(Q, A, checkpoint_every=3)


def test_resume_rejects_short_trace(tmp_path):
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build().run_arrays(Q, A, checkpoint_dir=d, checkpoint_every=4)
    with pytest.raises(ValueError, match="trace"):
        build().resume(d, Q[:3], A[:3])


def test_restore_skips_damaged_newest_step(tmp_path):
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build().run_arrays(Q[:7], A[:7], checkpoint_dir=d, checkpoint_every=4)
    steps = ckpt.available_steps(d)
    assert len(steps) >= 2
    newest = pathlib.Path(d) / f"step_{steps[-1]:012d}" / ckpt.ARRAYS
    newest.write_bytes(newest.read_bytes()[:20])
    o = build()
    pos = o.restore(d)                  # falls back to the older step
    assert pos == 4
    r = o.run_arrays(Q[pos:], A[pos:], _trace_offset=pos)
    assert_reports_equal(clean()[0][pos:], r)


def test_restore_rejects_wrong_population(tmp_path):
    from repro_torch.core.online import ChurnOrchestrator, population_cohorts
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build().run_arrays(Q[:5], A[:5], checkpoint_dir=d, checkpoint_every=5)
    pops = population_cohorts(U - 4, n_extra_edge=1, gamma=8, device=CPU)
    o = ChurnOrchestrator(population=pops, hysteresis=0.05)
    with pytest.raises(ValueError, match="users"):
        o.restore(d)


@pytest.mark.parametrize("saved,restored", [("congestion", "plain"),
                                            ("plain", "congestion")])
def test_restore_rejects_congestion_mismatch(saved, restored, tmp_path):
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build(saved).run_arrays(Q[:5], A[:5], checkpoint_dir=d,
                            checkpoint_every=5)
    with pytest.raises(ValueError, match="congestion"):
        build(restored).restore(d)


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        build().restore(str(tmp_path / "nothing"))


def test_checkpoint_extra_records_trace_position(tmp_path):
    Q, A = _trace()
    d = str(tmp_path / "ck")
    build().run_arrays(Q, A, checkpoint_dir=d, checkpoint_every=6)
    for s in ckpt.available_steps(d):
        man = json.loads((pathlib.Path(d) / f"step_{s:012d}" /
                          ckpt.MANIFEST).read_text())
        assert man["extra"]["n_users"] == U
        assert man["extra"]["trace_pos"] in (6, T)


# ---------------------------------------------------------------------------
# across the packages: one writes, the other resumes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_package_resume(writer, mode, tmp_path):
    """The reference's orchestrator checkpoints at trace position 7 and the
    port's resumes (or the reverse): the tail reports, incumbents and
    cohort state equal the writer's own uninterrupted run, and the two
    packages' manifests of that state agree on keys, dtypes and shapes."""
    Q, A = _trace()
    d = str(tmp_path / "ck")
    w_ref = writer == "ref"
    full = build(mode, ref=w_ref)
    r_full = full.run_arrays(Q, A)
    build(mode, ref=w_ref).run_arrays(Q[:7], A[:7], checkpoint_dir=d)
    reader = build(mode, ref=not w_ref)
    tail = reader.resume(d, Q, A)
    assert len(tail) == T - 7
    assert_reports_equal(r_full[7:], tail)
    assert_inc_equal(snap_incumbents(full), snap_incumbents(reader))
    assert_state_equal(full, reader)
    # the reader's own checkpoint of the same state: the same manifest
    d2 = str(tmp_path / "ck2")
    twin = build(mode, ref=not w_ref)
    twin.run_arrays(Q[:7], A[:7], checkpoint_dir=d2)
    (fa, ma), (fb, mb) = (rck.load_arrays(d, 7), ckpt.load_arrays(d2, 7)) \
        if w_ref else (rck.load_arrays(d2, 7), ckpt.load_arrays(d, 7))
    assert ma["keys"] == mb["keys"] and ma["dtypes"] == mb["dtypes"]
    assert ma["shapes"] == mb["shapes"] and ma["extra"] == mb["extra"]
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), k


# ---------------------------------------------------------------------------
# a real SIGKILL mid-run, then an in-process resume
# ---------------------------------------------------------------------------

def test_sigkill_then_resume_bit_identical(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen([sys.executable, __file__, ckpt_dir], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    # the worker must die from the signal, not exit on its own
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, out[-500:])
    assert "SIGKILL at tick" in out
    Q, A = _trace()
    r_clean, o_clean = clean()
    o = build()
    tail = o.resume(ckpt_dir, Q, A)
    pos = T - len(tail)
    assert 0 < pos <= KILL_TICK          # a pre-kill boundary checkpoint
    assert_reports_equal(r_clean[pos:], tail)
    assert_inc_equal(snap_incumbents(o_clean), snap_incumbents(o))
