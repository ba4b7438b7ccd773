"""Plain float32 training steps: next-token cross-entropy, its gradients,
and AdamW after a clip of the global gradient norm.

The recipe is the traffic file's ``optimizer``: clip the gradient to a
global norm of ``clip`` (unchanged below it), then AdamW with ``b1``,
``b2``, ``eps``, decoupled ``weight_decay`` on every leaf and learning
rate ``lr``, the moments starting at zero.

Memory. A 7B model's float32 weights, one step's gradients and two
moments would not fit one card beside the activations, so the reference
follows at most two steps and keeps only the weights and the first
step's clipped gradient G1: at step 2 the moments are
``m = b1 (1 - b1) G1 + (1 - b1) G2`` and ``v = b2 (1 - b2) G1^2 +
(1 - b2) G2^2``, what Adam's recursion gives from zero. A pass runs the
forward layer by layer under no_grad, keeping each layer's input, then the
backward layer by layer, each layer recomputed under autograd from its
input, so one layer's activations exist at a time. Step 2's update needs
its gradient's global norm before any leaf moves, so it takes two
backward passes over the same forward: the first for the norm, the second
to update each layer as its gradient comes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from .model import Matmul, block, rms_norm, rope_tables


def _layer_backward(d, w: Dict[str, torch.Tensor], x_in: torch.Tensor,
                    dx: torch.Tensor, cos, sin, mm: Matmul):
    """(dx_in, {name: dW}) of one block recomputed from its input."""
    x = x_in.detach().requires_grad_()
    ws = {k: v.detach().requires_grad_() for k, v in w.items()}
    with torch.enable_grad():
        out = block(x, ws, d, cos, sin, mm)
        names = list(ws)
        grads = torch.autograd.grad(out, [x] + [ws[k] for k in names], dx)
    return grads[0], dict(zip(names, grads[1:]))


class _Pass:
    """One forward over a batch: the loss and every layer's input, ready
    for any number of backward passes while the weights stay put."""

    def __init__(self, d, params: Dict[str, torch.Tensor], tokens, mm):
        self.d, self.params, self.mm = d, params, mm
        inp = tokens[:, :-1].long()
        self.inp, self.targets = inp, tokens[:, 1:].long()
        B, T = inp.shape
        self.cos, self.sin = rope_tables(T, d.head_dim, d.rope_theta,
                                         inp.device)
        with torch.no_grad():
            x = params["embed"][inp]
            self.xs = []
            for i in range(d.n_layers):
                self.xs.append(x)
                x = block(x, layer_of(params, d, i), d, self.cos, self.sin,
                          mm)
            self.x_last = x
            self.loss = self._head(x, need_grad=False)[0]

    def _head(self, x, need_grad: bool):
        """(loss, dx, {final_norm, lm_head grads})."""
        p, d = self.params, self.d
        x = x.detach().requires_grad_(need_grad)
        fn = p["final_norm"].detach().requires_grad_(need_grad)
        lm = p["lm_head"].detach().requires_grad_(need_grad)
        with torch.set_grad_enabled(need_grad):
            logits = self.mm(rms_norm(x, fn, d.rms_eps), lm)
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                self.targets.reshape(-1))
            if not need_grad:
                return float(loss), None, None
            dx, dfn, dlm = torch.autograd.grad(loss, [x, fn, lm])
        return float(loss.detach()), dx, {"final_norm": dfn, "lm_head": dlm}

    def backward(self, on_grad: Callable[[str, torch.Tensor], None]):
        """Every leaf's gradient, handed to ``on_grad(leaf, grad)`` in the
        order the backward reaches it (head, layers from the last, the
        embedding); the layer's weights may change inside ``on_grad``
        once its gradient is out."""
        d = self.d
        _, dx, head = self._head(self.x_last, need_grad=True)
        for name, g in head.items():
            on_grad(name, g)
        for i in reversed(range(d.n_layers)):
            w = layer_of(self.params, d, i)
            dx, gw = _layer_backward(d, w, self.xs[i], dx, self.cos,
                                     self.sin, self.mm)
            for name, g in gw.items():
                on_grad(f"blocks.{name}.{i}", g)
        emb = torch.zeros_like(self.params["embed"])
        emb.index_add_(0, self.inp.reshape(-1),
                       dx.reshape(-1, dx.shape[-1]))
        on_grad("embed", emb)


def layer_of(params: Dict[str, torch.Tensor], d, i: int
             ) -> Dict[str, torch.Tensor]:
    prefix, suffix = "blocks.", f".{i}"
    return {k[len(prefix):-len(suffix)]: v for k, v in params.items()
            if k.startswith(prefix) and k.endswith(suffix)}


def train_steps(d, params: Dict[str, torch.Tensor], batches: List,
                opt: Dict[str, float], precision: str = "fp32",
                initial: Optional[Callable[[str], torch.Tensor]] = None
                ) -> Dict:
    """Follow ``len(batches)`` (1 or 2) training steps from ``params``
    (leaf name -> float32 tensor, updated in place). Returns the loss of
    each step, each leaf's clipped first gradient (``grad``: the gradient
    as the optimizer takes it) and raw first gradient (``raw_grad``)
    norms, and each leaf's distance from ``initial(leaf)`` after the last
    step (``change``)."""
    if len(batches) not in (1, 2):
        raise ValueError("the reference follows one or two steps")
    mm = Matmul(precision)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["clip"]
    losses: List[float] = []
    out: Dict = {"grad": {}, "raw_grad": {}, "change": {}}

    def clip_coef(sq: float) -> float:
        norm = math.sqrt(sq)
        return 1.0 if norm < clip else clip / norm

    # step 1: keep every gradient, then move every leaf
    first = _Pass(d, params, batches[0], mm)
    losses.append(first.loss)
    g1: Dict[str, torch.Tensor] = {}
    first.backward(lambda name, g: g1.__setitem__(name, g))
    del first
    c1 = clip_coef(sum(float(torch.sum(g * g)) for g in g1.values()))
    for name, g in g1.items():
        out["raw_grad"][name] = float(torch.linalg.vector_norm(g))
        g.mul_(c1)                                      # G1 from here on
        out["grad"][name] = float(torch.linalg.vector_norm(g))
        p = params[name]
        # m_hat = G1, v_hat = G1^2 after one step
        p.sub_(lr * (g / (g.abs() + eps) + wd * p))

    if len(batches) == 2:
        second = _Pass(d, params, batches[1], mm)
        losses.append(second.loss)
        sq = [0.0]
        second.backward(lambda name, g: sq.__setitem__(
            0, sq[0] + float(torch.sum(g * g))))
        c2 = clip_coef(sq[0])
        bc1, bc2 = 1 - b1 ** 2, 1 - b2 ** 2

        def update(name, g):
            G1, G2 = g1.pop(name), g * c2
            m = b1 * (1 - b1) * G1 + (1 - b1) * G2
            v = b2 * (1 - b2) * G1 * G1 + (1 - b2) * G2 * G2
            p = params[name]
            p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p))

        second.backward(update)
        del second
    g1.clear()
    out["loss"] = losses
    if initial is not None:
        for name, p in params.items():
            out["change"][name] = float(torch.linalg.vector_norm(
                p - initial(name)))
    return out
