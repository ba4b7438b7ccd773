"""The roofline and FLOP arithmetic against values worked out by hand."""

import dataclasses
import json

import pytest

from benchmark import harness
from benchmark.models import dims, param_count
from benchmark.roofline import counts


def _dims(name):
    bench = harness.load_benchmark()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    return dims(json.loads((harness.ROOT / files[name]).read_text()))


@pytest.mark.parametrize("layers, total, step_flops", [
    (None, 5.4968e9, 2.835e14),  # the configuration as run: 24 layers
    (32, 7.2417e9, 3.76e14),     # the published depth
])
def test_mistral_parameters_and_training_flops(layers, total, step_flops):
    d = _dims("mistral-7b")
    if layers is None:
        assert d.n_layers == 24
    else:
        d = dataclasses.replace(d, n_layers=layers)
    L = d.n_layers
    n = param_count(d)
    # layers of 218.1e6 (attention 41.9e6, MLP 176.2e6, two norms), the
    # embedding and the head of 131.1e6 each
    per_layer = (4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
                 + 2 * 4096)
    assert n["layers"] == L * per_layer
    assert n["total"] == L * per_layer + 2 * 32000 * 4096 + 4096
    assert n["total"] == pytest.approx(total, rel=1e-4)
    flops = counts.train_step_flops(d, 2, 4096)
    matmul = n["total"] - 32000 * 4096
    attn = 12 * L * 2 * 32 * 128 * (4096 * 4097 // 2)
    assert flops == 6 * matmul * 8192 + attn
    assert flops == pytest.approx(step_flops, rel=2e-3)


def test_mixtral_stage_decode_streams_every_expert_once():
    d = _dims("mixtral-8x7b")
    assert (d.n_layers, d.n_experts, d.top_k) == (16, 8, 2)
    # with every expert hit: the stage's non-embedding weights
    weights = counts.decode_weight_bytes(d, tokens_per_step=1e9) \
        - 1e9 * 4096 * 2
    per_layer = (2 * (4096 * 4096 * 2 + 4096 * 1024 * 2)
                 + 2 * 8 * 3 * 4096 * 14336 + 4 * 4096 * 8 + 4 * 2 * 4096)
    assert weights == pytest.approx(16 * per_layer + 2 * 4096 * 32000
                                    + 4 * 4096)
    assert weights == pytest.approx(46.7e9, rel=2e-3)
    assert param_count(d)["total"] == pytest.approx(23.48e9, rel=1e-3)


def test_experts_touched_follows_uniform_routing():
    d = _dims("mixtral-8x7b")
    assert counts.experts_touched(d, 1) == pytest.approx(2.0)
    assert counts.experts_touched(d, 16) == pytest.approx(
        8 * (1 - 0.75 ** 16))
    assert counts.experts_touched(d, 16) > 0.989 * 8
    assert counts.experts_touched(_dims("mistral-7b"), 16) == 0.0


def test_decode_cost_counts_top_k_experts_not_dense_dispatch():
    d = _dims("mixtral-8x7b")
    one = counts.decode_cost(d, steps=1, token_steps=1, visible=100)
    # a token's matmuls: attention projections, router, two experts, head
    attn = 4096 * 6144 + 4096 * 4096
    ffn = 4096 * 8 + 2 * 3 * 4096 * 14336
    expect = 2 * ((attn + ffn) * 16 + 4096 * 32000) \
        + 4 * 100 * 32 * 128 * 16
    assert one["flops"] == pytest.approx(expect)
    assert one["flops"] < 2 * 23.5e9 * 0.6


def test_paged_decode_bytes_by_hand():
    d = _dims("mixtral-8x7b")
    # 3 sequences seeing 10, 20 and 30 positions: 60 rows of K and V per
    # layer (8 heads x 128 x 2 bytes each), a query and output per token
    got = counts.paged_decode_bytes(d, token_steps=3, visible=60)
    assert got == 16 * (60 * 2 * 8 * 128 * 2 + 3 * 2 * 32 * 128 * 2)


def test_flash_cost_is_fourteen_products_per_visible_pair():
    d = _dims("mistral-7b")
    cost = counts.flash_train_cost(d, 2, 4096)
    assert cost["flops"] == 14 * 2 * 32 * 128 * (4096 * 4097 // 2) * 24
    # per layer at B 2 x T 4096: 4.6e11 operations, far past the bytes
    assert counts.least_time(cost["flops"], cost["bytes"],
                             counts.peaks("NVIDIA H100 80GB HBM3")) \
        == pytest.approx(cost["flops"] / 989e12)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        counts.peaks("a card with no data sheet")
