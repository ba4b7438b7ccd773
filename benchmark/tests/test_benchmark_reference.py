"""The plain references against the port at a tiny size in float32 on the
CPU, where both must agree to rounding, and the float8 control against
both. (The test may import the port; the references themselves do not.)"""

import pytest
import torch

from benchmark.kinds import serve, train
from benchmark.reference.model import Matmul, sequence_logits
from benchmark.weights import make_layer, make_params, make_slab
from benchmark import traffic


def _reference(cell, seqs, starts, precision="fp32"):
    d = cell.dims
    head = {n: make_slab(d, cell.seed, n, -1, "cpu", torch.float32)
            for n in ("embed", "final_norm", "lm_head")}
    return sequence_logits(d, lambda i: make_layer(d, cell.seed, i, "cpu"),
                           head, seqs, starts, Matmul(precision))


@pytest.mark.parametrize("workload", ["mixtral-8x7b.serve.chat",
                                      "mistral-7b.train.t4096"])
def test_reference_logits_match_the_port_forward(tiny, workload):
    from k8s_operator_libs_tpu_torch.models import llama, moe

    from benchmark.models import port_config
    _, cell = tiny(workload)
    d = cell.dims
    params = make_params(d, cell.seed, "cpu")
    cfg = port_config(d, remat=False)
    gen = torch.Generator().manual_seed(3)
    seq = torch.randint(0, d.vocab, (40,), generator=gen)
    if d.family == "moe":
        logits, _ = moe.forward(params, seq[None, :-1], cfg)
    else:
        logits = llama.forward(params, seq[None, :-1], cfg)
    ref = _reference(cell, [seq], [10])[0]
    assert ref.shape == (29, d.vocab)
    torch.testing.assert_close(ref, logits[0, 10:], rtol=1e-4, atol=1e-4)


def test_reference_training_steps_match_the_port(tiny):
    _, cell = tiny("mistral-7b.train.t4096")
    d, dev = cell.dims, cell.device
    params = make_params(d, cell.seed, dev)
    deck = traffic.train_deck(cell.mix, cell.seed, d.vocab, dev)
    step, state = train.make_step(cell, params)
    _, prog = train.program_readings(cell, step, state, deck)
    ref = train.reference_readings(cell, deck)
    gaps = train.compare(prog, ref)
    assert all(v < 2e-5 for v in gaps.values()), gaps
    assert ref["loss"][1] != ref["loss"][0]


def test_the_float8_control_departs_from_the_reference(tiny):
    _, cell = tiny("mixtral-8x7b.serve.chat")
    gen = torch.Generator().manual_seed(4)
    seqs = [torch.randint(0, cell.dims.vocab, (n,), generator=gen)
            for n in (30, 50)]
    ref = _reference(cell, seqs, [5, 5])
    low = _reference(cell, seqs, [5, 5], "fp8")
    control = serve.gap_stats(ref, [lo.argmax(-1) for lo in low])
    exact = serve.gap_stats(ref, [r.argmax(-1) for r in ref])
    assert control["max_logit_gap"] > 0 and control["off_best_share"] > 0
    assert exact == {"max_logit_gap": 0.0, "mean_logit_gap": 0.0,
                     "off_best_share": 0.0}

    _, tcell = tiny("mistral-7b.train.t4096")
    deck = traffic.train_deck(tcell.mix, tcell.seed, tcell.dims.vocab, "cpu")
    exact = train.reference_readings(tcell, deck)
    control = train.reference_readings(tcell, deck, "fp8")
    gaps = train.compare(control, exact)
    assert gaps["grad_gap"] > 1e-3 and gaps["loss_gap"] > 1e-5
