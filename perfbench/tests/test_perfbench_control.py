"""The control comes out not correct, at a size a test run holds.

``control.readings`` puts the float8 reference in the program's place
(serving: the token it puts first at each served position; training:
its three AdamW steps), and for a training cell the reference with half
of each batch left out; each reading is held against the cell's own
limits (``limits/<workload>.json``).  The program itself, run in
float32 here, stays within them.  On the card the same readings at the
cells' own sizes set the limits (``PERF.md``)."""
import pytest
import torch

import control
import tiny
from harness import manifest


def _over(numbers: dict, limits: dict) -> list:
    return [k for k in limits if numbers[k] > limits[k]]


def _serve_parts():
    cfg = dict(tiny.DENSE, d_model=768, num_layers=12, head_dim=192,
               d_ff=3072, vocab_size=16384)
    mix = dict(tiny.SERVE, prompt_len={"dist": "log_uniform", "lo": 16,
                                       "hi": 64},
               max_new={"dist": "uniform", "lo": 16, "hi": 40},
               cache_len=104, check_requests=12)
    return {"program": cfg}, mix


def _train_parts(base):
    cfg = dict(base, d_model=256, num_layers=4, head_dim=64,
               vocab_size=4096, d_ff=base["d_ff"] * 4)
    return {"program": cfg}, dict(tiny.TRAIN, seq=64)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serving_control_is_not_correct(seed):
    cfg, mix = _serve_parts()
    lim = manifest.limits("sc2-complete")
    r = control.readings("sc2-complete", seed, 10.0, True,
                         torch.device("cpu"), cfg=cfg, mix=mix)
    assert not _over(r["program"], lim), r
    assert _over(r["control"], lim), r


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload,base", [("granite-train", tiny.MOE),
                                           ("sc2-train", tiny.DENSE)],
                         ids=["granite-train", "sc2-train"])
def test_training_control_and_half_batch_are_not_correct(workload, base,
                                                         seed):
    cfg, mix = _train_parts(base)
    lim = manifest.limits(workload)
    r = control.readings(workload, seed, 0.2, True, torch.device("cpu"),
                         cfg=cfg, mix=mix)
    assert not _over(r["program"], lim), r
    assert _over(r["control"], lim), r
    assert _over(r["half_batch"], lim), r
