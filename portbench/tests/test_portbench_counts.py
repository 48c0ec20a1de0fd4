"""The benchmark's operation and byte counts, at the published widths,
against values worked out by hand; and every share against the published
peaks, at most 100% on a timing at the bound."""
import pytest

from portbench import cell as CELL
from portbench.counts import lm, peaks
from portbench.tests import tiny


def spec(workload):
    return CELL.load(tiny.REPO, workload).spec


MIX = "mixtral8p.chat.b128"
MAMBA = "mamba2.chat.b256"


def test_mixtral_bytes_a_step():
    s = spec(MIX)
    experts = 8 * 8 * 3 * 6144 * 16384 * 2      # 8 layers of 8 experts
    assert experts == 38_654_705_664
    assert lm.live_experts(s, 128) == pytest.approx(8.0, abs=1e-12)
    layers = 8 * (6144 * 128 * (2 * 48 + 2 * 8) * 2 + 6144 * 8 * 4
                  + 2 * 6144 * 2)
    heads = 3 * 6144 * 32768 * 2
    pos = 999
    kv = 128 * 8 * 8 * 128 * 2 * 2 * (1000 + 1)
    rest = 4 * 6144 * 2 + 128 * 6144 * 2 + 3 * 128 * 32768 * 4
    assert lm.step_bytes(s, 128, pos) == pytest.approx(
        experts + layers + heads + kv + rest, rel=1e-12)


def test_mamba_state_bytes():
    s = spec(MAMBA)
    assert lm.ssm_dims(s) == (4096, 64, 64, 128)
    per_row = 64 * 64 * 128 * 4 * 48        # 48 layers of [64, 64, 128] f32
    assert per_row == 100_663_296
    assert 256 * per_row == 256 * 100_663_296
    conv = 48 * 3 * (4096 + 2 * 128) * 2
    assert lm.state_bytes(s, 256, 10) == 256 * 2 * (per_row + conv)


def test_flops_a_token():
    s = spec(MIX)
    attn = 2 * 6144 * 128 * (2 * 48 + 2 * 8)
    pos = 511
    scores = 4 * 48 * 128 * 512
    experts = 2 * 2 * 3 * 6144 * 16384
    router = 2 * 6144 * 8
    heads = 3 * 2 * 6144 * 32768
    assert lm.token_flops(s, pos) == 8 * (attn + scores + experts + router) \
        + heads
    m = spec(MAMBA)
    layer = 2 * 2048 * (2 * 4096 + 2 * 128 + 64) + 2 * 4096 * 2048 \
        + 2 * 4 * (4096 + 2 * 128) + 5 * 64 * 64 * 128
    assert lm.token_flops(m, 0) == 48 * layer + 3 * 2 * 2048 * 50277


@pytest.mark.parametrize("workload, padded, n", [
    (MIX, 32768, 20_435_159_040), (MAMBA, 51200, 1_345_629_184)])
def test_parameter_counts(workload, padded, n):
    assert lm.param_count(spec(workload), padded) == n


def test_shares_use_the_published_peaks_and_stay_at_most_100():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    s = spec(MIX)
    f, b = lm.moe_ffn_call(s, 128)
    at_bound = max(f / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
    assert peaks.roofline_share(f, b, at_bound) == pytest.approx(100.0)
    assert peaks.roofline_share(f, b, 2 * at_bound) == pytest.approx(50.0)
    f, b = lm.decode_attn_call(s, 128, 4000)
    t = max(f / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
    assert peaks.roofline_share(f, b, t) <= 100.0 + 1e-9
    # the whole step: mfu and the HBM share of a step timed at its bound
    step_b = lm.step_bytes(s, 128, 100)
    step_f = lm.step_flops(s, 128, 100)
    t = step_b / peaks.HBM_BYTES_PER_S
    assert 100.0 * step_b / (t * peaks.HBM_BYTES_PER_S) == pytest.approx(100)
    assert 100.0 * step_f / (t * peaks.BF16_FLOPS) <= 100.0
    with pytest.raises(ValueError):
        peaks.roofline_share(f, b, 0.0)
