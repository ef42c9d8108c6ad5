"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.execute``: the driver, the
window, the check against the reference, the limits of the cell) on the
CPU at a small size, past the look for a card, once sound and once for
each fault the cell can have: a served token altered where it is
produced; a training step that returns its state unchanged; half of the
batch left out, the mean taken over the rest.  The cells run on one
card, so no exchange between cards can be left out."""
import contextlib
import time

import pytest
import torch

import run
import tiny


def _execute(workload, fault=None):
    cfg, mix = tiny.cell_parts(workload)
    return run.execute(workload, 2**31 + 5, 1.0, False, torch.device("cpu"),
                       time.perf_counter(), cfg=cfg, mix=mix, fault=fault)


def _alter_a_token(eng):
    """Every decode step, each emitted token is replaced by the next id
    before it reaches its request, so every request that finishes in the
    window carries an altered token."""
    step = eng.step

    def altered():
        out = step()
        for i, (rid, tok) in enumerate(out):
            new = (tok + 1) % eng.cfg.vocab_size
            eng.requests[rid].out[-1] = new
            out[i] = (rid, new)
        return out

    eng.step = altered


@contextlib.contextmanager
def _state_unchanged():
    from repro_torch.optim import adamw
    update = adamw.update

    def frozen(cfg, grads, state, params, **kw):
        return params, state, {"grad_norm": torch.zeros(())}

    adamw.update = frozen
    try:
        yield
    finally:
        adamw.update = update


@contextlib.contextmanager
def _half_batch():
    from repro_torch.runtime import train as rt
    lg = rt.loss_and_grads

    def half(cfg, params, batch, **kw):
        B = batch["tokens"].shape[0]
        return lg(cfg, params, {k: v[:B // 2] for k, v in batch.items()},
                  **kw)

    rt.loss_and_grads = half
    try:
        yield
    finally:
        rt.loss_and_grads = lg


@pytest.mark.parametrize("workload", ["sc2-complete", "granite-train",
                                      "sc2-train"])
def test_a_sound_run_is_correct(workload):
    r = _execute(workload)
    assert r["correct"], r["checks"]


def test_an_altered_token_is_not_correct():
    r = _execute("sc2-complete", fault=_alter_a_token)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
@pytest.mark.parametrize("workload", ["granite-train", "sc2-train"])
def test_a_broken_train_step_is_not_correct(workload, fault):
    r = _execute(workload, fault=fault)
    assert not r["correct"], r["checks"]
