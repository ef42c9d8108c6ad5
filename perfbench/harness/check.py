"""What decides ``correct``: the program's outputs against the plain
float32 reference (``reference/``), which makes its weights again from
the seed and takes nothing the program made.

Serving: for a sample of the requests that finished in the window (the
longest among them), the reference runs once over each prompt with its
served tokens; at each served position the gap by which the served
token's logit lies below the reference's best.  The number compared is
the widest gap.  Greedy tokens only: the mix decodes greedily.

Training: the first three steps of the program (set-up drives them
through the window's own call and feed) against the reference's three
AdamW steps from the same weights and batches: the relative gap of the
first step's loss (the later steps' losses swing from seed to seed with
the updates before them; they are read, not compared); by the worst
leaf, the gap between the norms of the
first clipped gradient (the program's worked out from its first moment
after one step) and, after three steps, of each leaf's change, each
against the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose first reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left
out of the change.
"""
from __future__ import annotations

import gc
import statistics

import numpy as np
import torch

from .weights import get, leaf_paths, make_params, put


def serve_sample(finished: list, n: int, rng) -> list:
    """Up to ``n`` finished requests drawn by ``rng``, the longest
    (prompt and output) always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i].prompt) + len(finished[i].out))
    rest = [i for i in range(len(finished)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def _served_logits(ref, params, prompt, out, device):
    seq = torch.from_numpy(np.concatenate([prompt, np.asarray(out[:-1],
                                                              np.int64)]))
    at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out))
    return ref.serve_logits(params, seq.to(device), at.to(device))


def serve_gaps(m: dict, seed: int, device, pairs: list,
               control: bool = False) -> list:
    """Per served token, the reference's best logit minus its logit of
    the token served (``pairs``: (prompt ids, served ids)); with
    ``control``, of the token the float8 reference puts first at the
    same positions instead."""
    from reference import family
    from reference.model import strict_fp32
    strict_fp32()
    params = make_params(m, seed, device)
    Ref = family(m).Ref
    ref = Ref(m)
    low = Ref(m, quant=True) if control else None
    gaps = []
    for prompt, out in pairs:
        lg = _served_logits(ref, params, prompt, out, device)
        if control:
            tok = _served_logits(low, params, prompt, out,
                                 device).argmax(-1)
        else:
            tok = torch.as_tensor(out, device=device)
        best = lg.max(-1).values
        gaps += (best - lg.gather(1, tok[:, None].long())[:, 0]).tolist()
        del lg
    del params
    gc.collect()
    return gaps


def serve_gap(m: dict, seed: int, device, pairs: list) -> float:
    """The widest gap over the sample; inf for an empty sample (a
    window that finished nothing is not correct)."""
    gaps = serve_gaps(m, seed, device, pairs)
    return max(gaps) if gaps else float("inf")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def reference_train(m: dict, seed: int, device, feed, steps: int,
                    capacity_factor: float, lr: float, quant: bool = False,
                    rows=None) -> dict:
    """The reference's readings over ``steps`` AdamW steps on
    ``feed(0..steps-1)``: {"loss": [...], "grad": {path: norm of the
    first clipped gradient}, "change": {path: norm of the change after
    the last step}}.  ``rows`` keeps only those rows of each batch (a
    planted fault)."""
    from reference import family
    from reference.adamw import AdamW
    from reference.model import strict_fp32
    strict_fp32()
    paths = leaf_paths(m)
    p0 = make_params(m, seed, device)
    leaves = [get(p0, p).float().clone().requires_grad_(True) for p in paths]
    del p0
    tree = _tree(paths, leaves)
    ms = [torch.zeros_like(t) for t in leaves]
    vs = [torch.zeros_like(t) for t in leaves]
    ref = family(m).Ref(m, quant=quant)
    opt = AdamW(lr=lr)
    out = {"loss": [], "grad": {}, "change": {}}
    for t in range(steps):
        total, loss, _ = ref.loss(tree, feed(t), capacity_factor,
                                  rows=rows)
        grads = torch.autograd.grad(total, leaves)
        out["loss"].append(float(loss.detach()))
        del total, loss
        norms = opt.step(leaves, list(grads), ms, vs, t + 1)
        del grads
        if t == 0:
            out["grad"] = dict(zip(paths, norms))
    del ms, vs
    gc.collect()
    p0 = make_params(m, seed, device)
    with torch.no_grad():
        for p, leaf in zip(paths, leaves):
            out["change"][p] = float(torch.linalg.vector_norm(
                leaf - get(p0, p).float()))
    del p0, leaves, tree
    gc.collect()
    return out


def _tree(paths, leaves) -> dict:
    tree: dict = {}
    for p, leaf in zip(paths, leaves):
        put(tree, p, leaf)
    return tree


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    return max(_leaf_gaps(prog, ref, keep).values())


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves of largest gap, of the gradient and of the
    change, with the two norms of each (a look at a reading)."""
    out = {}
    for what in ("grad", "change"):
        gaps = _leaf_gaps(prog[what], ref[what])
        top = sorted(gaps, key=lambda k: -gaps[k])[:n]
        out[what] = [[".".join(map(str, k)), gaps[k], prog[what][k],
                      ref[what][k]] for k in top]
    return out


def unmoved(ref: dict) -> list:
    """Leaves whose first reference gradient is under a thousandth of the
    median leaf's: they move by round-off alone."""
    gmed = statistics.median(ref["grad"].values())
    return [k for k, g in ref["grad"].items() if g < 1e-3 * gmed]


def loss_gaps(prog: dict, ref: dict) -> list:
    """Each step's relative loss gap (read, not compared)."""
    return [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The three numbers compared (module docstring)."""
    loss = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    moved = set(ref["grad"]) - set(unmoved(ref))
    return {"first_loss_rel_gap": loss,
            "grad_norm_gap": _leaf_gap(prog["grad"], ref["grad"]),
            "change_norm_gap": _leaf_gap(prog["change"], ref["change"],
                                         moved)}
