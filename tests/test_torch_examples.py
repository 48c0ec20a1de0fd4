"""The port's four examples (``examples_torch/``) on the CPU.

* ``quickstart`` prints what the reference's ``examples/quickstart.py``
  prints, line for line: FIN (B1's plain version), MCP and Opt on the
  paper scenario.
* ``multiapp_placement`` prints the reference's table for the same users
  and seed (``run_multiapp`` on both packages).
* ``serve_split`` serves the reduced qwen3-4b through a node failure and
  its recovery; its FIN placement, the failure and the re-placement lines
  equal the reference example's.
* ``train_lm --small`` trains, checkpoints and resumes, and the loss
  falls; its configuration (the reference's "~100M", 55,588,352
  parameters by ``launch.flops.param_count``) counts the reference's
  parameters.

Each runs with ``--device cpu``; without it, each raises where there is
no card (``tests/test_torch_isolation.py``).
"""
import importlib.util
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return _load(REPO / "examples_torch" / f"{name}.py", f"port_ex_{name}")


def ref(name):
    return _load(REPO / "examples" / f"{name}.py", f"ref_ex_{name}")


def _run_ref(name, capsys, monkeypatch, argv=()):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    assert ref(name).main() == 0
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_output(capsys, monkeypatch):
    assert port("quickstart").main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want = _run_ref("quickstart", capsys, monkeypatch)
    assert got.splitlines() == want.splitlines()
    assert "FIN(g=10)" in got and "l1@mobile" in got


def test_multiapp_prints_the_reference_table(capsys, monkeypatch):
    argv = ["--users", "3", "--seed", "2"]
    assert port("multiapp_placement").main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want = _run_ref("multiapp_placement", capsys, monkeypatch, argv)
    assert got.splitlines() == want.splitlines()
    assert "mean FIN/MCP energy ratio" in got


def test_serve_split_places_as_the_reference(capsys, monkeypatch):
    assert port("serve_split").main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want = _run_ref("serve_split", capsys, monkeypatch)

    def placements(out):
        return [l for l in out.splitlines()
                if l.startswith(("FIN placement:", "!! node",
                                 "new placement:", "   node"))]
    assert placements(got) == placements(want)
    assert len(placements(got)) == 4
    assert "tokens generated : 72" in got


def test_train_lm_learns_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.runtime.checkpoint import available_steps
    ex = port("train_lm")
    argv = ["--small", "--steps", "16", "--batch", "4", "--seq", "32",
            "--ckpt", str(tmp_path), "--device", "cpu"]
    assert ex.main(argv) == 0
    out = capsys.readouterr().out
    assert "over 16 steps (resumed_from=None)" in out and "OK" in out
    assert available_steps(tmp_path) == [16]
    assert ex.main(argv) == 0
    assert "the checkpoint is at step 16" in capsys.readouterr().out
    argv[2] = "60"
    assert ex.main(argv) == 0
    assert "(resumed_from=16)" in capsys.readouterr().out
    assert available_steps(tmp_path) == [16, 50, 60]


def test_train_lm_config_counts_the_reference_parameters():
    from repro.launch.flops import param_count as ref_count
    from repro_torch.launch.flops import param_count
    cfg, ref_cfg = port("train_lm").build_config(), ref(
        "train_lm").build_config()
    assert param_count(cfg) == ref_count(ref_cfg)
    assert param_count(cfg) == 55_588_352


@pytest.mark.parametrize("name", ["quickstart", "multiapp_placement",
                                  "serve_split", "train_lm"])
def test_examples_have_a_main_with_a_device_flag(name):
    src = (REPO / "examples_torch" / f"{name}.py").read_text()
    assert "def main(argv=None)" in src and '"--device"' in src
    assert 'if __name__ == "__main__":' in src
