"""The harness's CPU mode against the plain reference, at CPU-test sizes.

In float32 the program and the reference serve the same tokens: every
compared number reads 0.  The reference is also held to the program's own
full-sequence forward, leaf for leaf of the weights the benchmark makes.
"""
import itertools
import math

import numpy as np
import pytest
import torch

from portbench import cell as CELL
from portbench import serve as S
from portbench import traffic as TR
from portbench import weights as WT
from portbench.reference import lm as RLM
from portbench.reference import placement as RPL
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_cpu_run_matches_reference(root, workload):
    res = tiny.run(root, workload)
    assert res["correct"], res["checks"]
    assert res["readings"]["tokens_checked"] > 0
    for name, c in res["checks"].items():
        assert c["value"] == 0.0, (name, c)
    assert set(res["metrics"]) == {
        m["name"] for m in CELL.load(root, workload).end_to_end}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("config, length", [("tiny-moe", 8),
                                            ("tiny-ssm", 24)])
def test_reference_is_the_programs_forward(root, config, length):
    """Against ``forward_train`` over ``length`` tokens; for the MoE layer
    at most 8, where its capacity (8 slots an expert at least) drops no
    token, as a decode step (one token a group) never does."""
    from repro_torch.models import transformer as T
    workload = next(w for w, (c, _, _) in tiny.CELLS.items() if c == config)
    cell = CELL.load(root, workload)
    cfg = S.arch_config(cell)
    params = WT.make_params(T.init_model(cfg, device="meta"), 11,
                            torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, length)))
    got = T.forward_train(params, cfg, {"tokens": tokens})
    R, P = tokens.shape
    rows = torch.arange(R).repeat_interleave(P)
    pos = torch.arange(P).repeat(R)
    ref = RLM.forward(cell.spec, params, tokens, rows, pos)
    for name in RLM.heads_order(cell.spec):
        prog = got[name][..., :cfg.vocab_size].reshape(R * P, -1)
        assert torch.allclose(prog, ref[name], atol=2e-4, rtol=2e-4), name


def test_weights_are_seeded_and_scaled():
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    cfg = get("mixtral-8x22b", reduced=True)
    meta = T.init_model(cfg, device="meta")
    a = WT.make_params(meta, 5, torch.device("cpu"))
    b = WT.make_params(meta, 5, torch.device("cpu"))
    c = WT.make_params(meta, 6, torch.device("cpu"))
    wa = a["layers"]["l0"]["mlp"]["w_gate"]
    assert torch.equal(wa, b["layers"]["l0"]["mlp"]["w_gate"])
    assert not torch.equal(wa, c["layers"]["l0"]["mlp"]["w_gate"])
    assert abs(float(wa.float().std()) * math.sqrt(cfg.d_model) - 1) < 0.1
    assert torch.equal(a["final_norm"]["scale"],
                       torch.ones_like(a["final_norm"]["scale"]))
    assert T.param_count(a) == T.param_count(T.init_model(cfg, seed=0,
                                                          device="cpu"))


def test_every_seed_serves_the_same_lengths():
    mix = TR.load(tiny.PORTBENCH / "traffic" / "chat.b128.json")
    seen = []
    for seed in (1, 2 ** 31 + 17):
        r = TR.Requests(mix, seed, 32768)
        lens = sorted((len(s.prompt), s.max_new_tokens)
                      for s in (r.next(c % 128) for c in range(256)))
        seen.append(lens)
        assert len({len(s.prompt) for s in
                    (r.next(0) for _ in range(3))}) > 1
    assert seen[0] == seen[1]
    assert min(p for p, _ in seen[0]) >= 32 and max(p for p, _ in seen[0]) \
        <= 2048


def test_churn_ticks_hold_one_outage_a_block():
    churn = TR.load(tiny.PORTBENCH / "traffic" / "churn.b128.json")["churn"]
    for seed in (3, 2 ** 31 + 5):
        src = TR.ChurnTicks(churn, seed)
        ticks = [src.next() for _ in range(400)]
        fails = [i for i, t in enumerate(ticks)
                 if any(e[0] == "fail" for e in t)]
        assert len(fails) == 8
        assert all(churn["q_lo"] <= t[0][2] <= churn["q_hi"] for t in ticks)
        down = False
        for t in ticks:
            kinds = [e[0] for e in t]
            if "recover" in kinds:
                assert down
                down = False
            if "fail" in kinds:
                assert not down
                down = True


def test_placement_reference_matches_the_programs_evaluation():
    from repro_torch.core import Config, evaluate_config, paper_profile
    from repro_torch.core.scenarios import paper_scenario
    data = CELL.load(tiny.REPO, "mixtral8p.churn.b128").config["placement"]
    state = RPL.base_network(data)
    prof = RPL.Profile(data)
    net, prog_prof, req = S.placement_inputs({"placement": data})
    ref_net = paper_scenario(uplink_bps=0.3e9)
    assert np.array_equal(net.bandwidth, ref_net.bandwidth)
    assert np.array_equal(net.compute, ref_net.compute)
    assert net.nodes == ref_net.nodes
    assert prog_prof.block_ops == paper_profile("h1").block_ops
    assert prog_prof.exits == paper_profile("h1").exits
    for k, e in enumerate(prof.exits):
        for place in itertools.product(range(3), repeat=e["block"] + 1):
            ev = RPL.evaluate(state, prof, data["req"], place, k)
            pe = evaluate_config(net, prog_prof, req, Config(list(place), k))
            assert ev.feasible == pe.feasible
            assert math.isclose(ev.energy, pe.energy, rel_tol=1e-12)
            assert math.isclose(ev.latency, pe.latency, rel_tol=1e-12)
