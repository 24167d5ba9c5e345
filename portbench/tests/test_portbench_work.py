"""``work.py``'s counts against values worked out by hand.

Yi-6B: embedding and head 2 x 64,000 x 4,096 = 524,288,000; a layer's
attention 2 x 4,096 x 4,096 + 2 x 4,096 x 512 = 37,748,736, its MLP
3 x 4,096 x 11,008 = 135,266,304, its norms 8,192: 173,023,232 a layer,
5,536,743,424 for 32; with the final norm's 4,096, 6,061,035,520.

DeepSeek-MoE-16B: embedding and head 2 x 102,400 x 2,048 = 419,430,400
and the final norm 2,048; attention 4 x 2,048^2 = 16,777,216 a layer;
the dense first layer's MLP 3 x 2,048 x 10,944 = 67,239,936; each of 27
MoE layers 64 experts of 3 x 2,048 x 1,408 = 8,650,752 (553,648,128), 2
shared (17,301,504) and the router 131,072; norms 4,096 a layer.  In
all 16,375,728,128 (``ModelConfig.n_params``, 16,393,027,584, counts the
shared experts in the dense first layer too), of which
a token runs through 16,375,728,128 - 27 x 58 x 8,650,752 =
2,828,650,496.
"""

import json

import pytest

from portbench import work
from portbench.spec import HERE


def conf(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,params,active,kv", [
    ("yi6b", 6_061_035_520, 6_061_035_520, 65_536),
    ("dsmoe16b", 16_375_728_128, 2_828_650_496, 229_376),
    ("yi6b_pp2", 3_292_663_808, 3_292_663_808, 32_768),
])
def test_parameters_and_kv_bytes(name, params, active, kv):
    c = conf(name)
    assert work.n_params(c) == params
    assert work.n_active(c) == active
    assert work.kv_bytes_per_position(c) == kv


def test_experts_touched_at_a_decode_batch_of_64():
    c = conf("dsmoe16b")
    assert work.experts_touched(c, 64) / 64 == pytest.approx(
        1 - (1 - 6 / 64) ** 64)
    assert 0.997 < work.experts_touched(c, 64) / 64 < 0.999
    assert work.experts_touched(conf("yi6b"), 64) == 0


def test_decode_prefill_train_and_k4_counts():
    c = conf("yi6b")
    flops, nbytes = work.decode_step(c, 1, 100)
    # a token through every matrix (the embedding lookup is none) and
    # 100 positions of attention in each of 32 layers
    matmul = 6_061_035_520 - 64_000 * 4_096 - 32 * 8_192 - 4_096
    assert flops == 2 * matmul + 4 * 32 * 32 * 128 * 100
    weights = 2 * (6_061_035_520 - 64_000 * 4_096 + 4_096)
    assert nbytes == weights + 100 * 65_536 + 2 * 64_000
    pf, pb = work.prefill(c, 10)
    assert pf == 2 * 10 * (matmul - 64_000 * 4_096) + 2 * 64_000 * 4_096 \
        + 2 * 32 * 32 * 128 * 10 * 11
    t = conf("yi6b_pp2")
    tf, _ = work.train_step(t, 2, 4096)
    assert tf / 1e12 == pytest.approx(162.15, abs=0.01)
    assert work.k4_bytes(c, 2, 300) == 32 * (300 * 2 * 4 * 128 * 2
                                             + 2 * 2 * 32 * 128 * 2)
    assert work.least_s(989e12, 1.0) == pytest.approx(1.0)
    assert work.least_s(1.0, 3.35e12) == pytest.approx(1.0)
