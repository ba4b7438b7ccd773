"""Faults planted under the timed path, to show that the output check
catches them. Each is a context manager that patches the program while
it is active; the tests and ``calibrate.py`` run a cell inside one.

Serving: ``kv_unchanged`` (no step writes the KV cache: a step that
returns its state unchanged) and ``token_altered`` (the last token of
every decode chunk is replaced by the next id, where the batcher
produces it). Training: ``state_unchanged`` (the optimizer returns its
state and leaves the weights alone) and ``half_batch`` (each step sees
half of its batch's rows, its loss the mean over them). One card holds
no exchange between chips, so that fault has nothing to break here.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def kv_unchanged():
    from k8s_operator_libs_tpu_torch.models import paged

    return _patched(paged, "_paged_write", lambda *args, **kwargs: None)


def token_altered():
    from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher

    decode = ContinuousBatcher._decode

    def altered(self, n):
        out = decode(self, n)
        out[-1] = (out[-1] + 1) % self.cfg.vocab_size
        return out

    return _patched(ContinuousBatcher, "_decode", altered)


def state_unchanged():
    from k8s_operator_libs_tpu_torch.parallel import fsdp

    def update(self, grads, state, params, g_norm):
        return fsdp.AdamWState(count=state.count + 1, mu=state.mu,
                               nu=state.nu)

    return _patched(fsdp.ClippedAdamW, "update", update)


def half_batch():
    from k8s_operator_libs_tpu_torch.parallel import fsdp

    make = fsdp.make_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda state, tokens: step(state,
                                          tokens[:tokens.shape[0] // 2])

    return _patched(fsdp, "make_train_step", make_half)


SERVE = {"kv_unchanged": kv_unchanged, "token_altered": token_altered}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
