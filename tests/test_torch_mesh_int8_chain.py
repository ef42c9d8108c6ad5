"""The CPU rehearsal of ``chip_smoke.py``'s int8 chain on a mesh
([mesh] (e), its int8 case): a reduced dense decoder on a model-4 mesh
(the cache length sharded) with int8 caches, prefilled and decoded on
the mesh from its own prefill's codes, against one process:

* one process decoding from the mesh prefill's codes (gathered whole)
  gives the mesh's logits within ``chip_smoke.MESH_SERVE_RTOL``: the
  chain, prefill to decode, held whole;
* one process decoding from its own prefill's codes moves from that by
  at most ``chip_smoke.int8_flip_bound`` of the codes that differ
  between the two prefills (each flipped code one scale step), a check
  of its own beside ``MESH_SERVE_RTOL``;
* those codes differ by one step at most, on at most
  ``chip_smoke.MESH_SERVE_CODE_SHARE`` of them.
"""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke                                                  # noqa
from torch_int8_chain_cases import (CACHE_LEN, PROMPT, SHAPE,       # noqa
                                    chain_cfg, chain_inputs, chain_rank,
                                    layout_params)
from repro_torch._tree import leaves, tree_map                     # noqa
from repro_torch.models import transformer as tfm                  # noqa
from repro_torch.runtime.meshenv import make_env                   # noqa


def _decode(cfg, params, caches, steps) -> list:
    caches = tree_map(lambda t: t.clone(), caches)
    out = []
    with torch.no_grad():
        for i, tok in enumerate(steps):
            logits, _, caches = tfm.decode_step(cfg, params, tok[:, None],
                                                PROMPT + i, caches)
            out.append(logits)
    return out


def test_the_int8_chain_on_a_mesh_is_held_whole(tmp_path):
    from torch_mesh_ranks import run_world
    mesh = run_world(chain_rank, 4, tmp_path)[0]
    cfg = chain_cfg()
    inputs = chain_inputs(cfg)
    params = layout_params(cfg, make_env({"data": SHAPE[0],
                                          "model": SHAPE[1]}))
    with torch.no_grad():
        _, own = tfm.prefill(cfg, params, {"tokens": inputs["tokens"]},
                             cache_len=CACHE_LEN, kv_quant=True)
    V = cfg.vocab_size
    chain = _decode(cfg, params, mesh["prefill_caches"], inputs["steps"])
    mine = _decode(cfg, params, own, inputs["steps"])
    errs = [chip_smoke._normwise(got[:, :V], want[:, :V])
            for got, want in zip(mesh["logits"], chain)]
    assert max(errs) <= chip_smoke.MESH_SERVE_RTOL, errs
    flipped = chip_smoke._code_flips(mesh["prefill_caches"], own)
    codes = sum(t.numel() for t in leaves(own) if t.dtype == torch.int8)
    assert codes and flipped <= chip_smoke.MESH_SERVE_CODE_SHARE * codes
    for g, w in zip(leaves(mesh["prefill_caches"]), leaves(own)):
        if w.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max() <= 1
    bound = chip_smoke.int8_flip_bound(flipped, PROMPT)
    moves = [chip_smoke._normwise(got[:, :V], want[:, :V])
             for got, want in zip(chain, mine)]
    assert max(moves) <= bound, (moves, bound)
    print(f"mesh against one process from its codes {max(errs):.3g}; "
          f"flipped codes {flipped} of {codes}, their move {max(moves):.3g} "
          f"within {bound:.3g}")
