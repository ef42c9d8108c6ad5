"""The plain float32 reference (``reference/``) against the program's
plain path on the CPU at a small width: serving logits through prefill
and the cache, the training loss, aux and every gradient (the dense
block and the routed experts, with and without dropped assignments),
and the AdamW step.  The only place a benchmark file runs the program's
plain path."""

import numpy as np
import pytest
import torch

from harness.weights import get, leaf_paths, make_params
from reference.adamw import AdamW
from reference.model import Ref
from repro_torch._tree import leaves, unflatten
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from harness.common import model_config
from tiny import DENSE, DENSE_LOCAL, MOE


@pytest.mark.parametrize("m", [DENSE, DENSE_LOCAL],
                         ids=["global", "sliding-window"])
def test_serving_logits_through_the_cache(m):
    """Prefill and decode through the cache against the reference's full
    forward; with a window of 8 the 13-token prompt and the decode steps
    wrap the program's ring of 8 slots."""
    cfg = model_config(m)
    params = make_params(m, 7, "cpu")
    ref = Ref(m)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, m["vocab_size"], size=13)
    logits, caches = tfm.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompt)[None]}, cache_len=24)
    got = [logits[0, :m["vocab_size"]]]
    toks = [int(torch.argmax(got[0]))]
    for i in range(5):
        lg, nxt, caches = tfm.decode_step(
            cfg, params, torch.tensor([[toks[-1]]]), len(prompt) + i, caches)
        got.append(lg[0, :m["vocab_size"]])
        toks.append(int(nxt[0]))
    seq = torch.from_numpy(np.concatenate([prompt, toks[:-1]]))
    want = ref.serve_logits(params, seq, torch.arange(len(prompt) - 1,
                                                      len(seq)))
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4,
                               atol=1e-4)


def _program_grads(m, params, batch, cap):
    cfg = model_config(m)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, met = tfm.loss_fn(cfg, params, batch, remat=True,
                             capacity_factor=cap)
    grads = torch.autograd.grad(total, flat)
    return total, met, unflatten(params, list(grads))


@pytest.mark.parametrize("m,cap", [(DENSE, 1.25), (DENSE_LOCAL, 1.25),
                                   (MOE, 1.25), (MOE, 0.5)],
                         ids=["dense", "dense-sliding-window", "moe",
                              "moe-drops"])
def test_loss_and_every_gradient(m, cap):
    from harness.data import batch_at
    batch = batch_at(m["vocab_size"], 4, 16, 11, 0)
    params = make_params(m, 5, "cpu")
    total, met, grads = _program_grads(m, params, batch, cap)
    paths = leaf_paths(m)
    mine = [get(params, p).detach().clone().requires_grad_(True)
            for p in paths]
    from harness.check import _tree
    rt, rl, ra = Ref(m).loss(_tree(paths, mine), batch, cap)
    rg = torch.autograd.grad(rt, mine)
    torch.testing.assert_close(total.detach(), rt.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(met["aux"].detach(), ra.detach(), rtol=1e-5,
                               atol=1e-6)
    for p, g in zip(paths, rg):
        torch.testing.assert_close(get(grads, p), g, rtol=1e-4, atol=1e-6,
                                   msg=lambda s: f"{p}: {s}")


def test_moe_drops_assignments_at_small_capacity():
    """The dispatch case above drops: some expert receives more than its
    capacity at factor 0.5."""
    from harness.data import batch_at
    from harness.frozen import moe_capacity
    m = MOE
    batch = batch_at(m["vocab_size"], 4, 16, 11, 0)
    params = make_params(m, 5, "cpu")
    ref = Ref(m)
    h = ref.embed(params, batch["tokens"])
    x = ref.rms(h, params["layers"][0]["ln2"]).reshape(-1, m["d_model"])
    idx = torch.topk(torch.softmax(x @ params["layers"][0]["ffn"][
        "router"], -1), m["experts_per_token"], -1).indices
    counts = torch.bincount(idx.reshape(-1), minlength=m["num_experts"])
    assert int(counts.max()) > moe_capacity(64, m["num_experts"],
                                            m["experts_per_token"], 0.5)


def test_adamw_three_steps():
    g = torch.Generator().manual_seed(3)
    shapes = [(8, 5), (13,), (4, 3, 2)]
    p0 = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 3 for s in shapes]
             for _ in range(3)]
    prog = [t.clone() for t in p0]
    state = adamw.init(prog)
    cfg = adamw.AdamWConfig(lr=1e-2)
    for gs in grads:
        prog, state, _ = adamw.update(cfg, gs, state, prog)
        if state.step == 1:
            first = [float(torch.linalg.vector_norm(m)) / (1 - cfg.b1)
                     for m in state.m]
    ref = [t.clone() for t in p0]
    ms = [torch.zeros_like(t) for t in p0]
    vs = [torch.zeros_like(t) for t in p0]
    opt = AdamW(lr=1e-2)
    for t, gs in enumerate(grads):
        norms = opt.step(ref, gs, ms, vs, t + 1)
        if t == 0:
            np.testing.assert_allclose(norms, first, rtol=1e-6)
    for a, b in zip(prog, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
