"""The port's training path (``repro_torch.models.transformer.loss_fn``,
the backward of kernel rows 3 and 4, ``repro_torch.runtime.train``)
against the JAX package's on the same weights and batches.

Weights come from the reference's ``init_lm`` (norm weights randomised)
through ``interop.lm_params_from_numpy``; batches from the reference's
``batch_at``, as numpy; gradients of the reference's tree are mapped
through the same unstacking.  All in float32.  Tolerances:

* ``loss_fn``: the loss to 1e-5 relative, every gradient leaf to 1e-4
  in error RMS over the reference's RMS (the same float32 math summed in
  other orders; the readings are ~1e-6).  ``remat`` on and off give the
  same bits in the port (the recomputed forward is the same ops).
* The plain backward versions of rows 3 and 4 against ``jax.grad`` of
  the reference's jnp ``flash_attention`` and ``rms_norm``: 1e-5 in
  error RMS over the reference's RMS, and elementwise 1e-4 relative with
  an absolute floor of 1e-5 of the largest gradient.
* ``make_train_step``: the loss and grad-norm trajectories over 4 AdamW
  steps to 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as j_attn                        # noqa
from repro.models import sharded_ops as j_sharded                   # noqa
from repro.models import transformer as jtfm                        # noqa
from repro.models.layers import rms_norm as j_rms_norm              # noqa
from repro.optim import schedules as j_sched                        # noqa
from repro.runtime import train as j_train                          # noqa
from repro.runtime.data import DataConfig as JDataConfig            # noqa
from repro.runtime.data import batch_at as j_batch_at               # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch import _tree, interop                              # noqa
from repro_torch.kernels.flash_attention import ref as fref         # noqa
from repro_torch.kernels.rmsnorm import ref as rref                 # noqa
from repro_torch.models import sharded_ops as t_sharded             # noqa
from repro_torch.models import transformer as ttfm                  # noqa
from repro_torch.optim import adamw as t_adamw                      # noqa
from repro_torch.optim import schedules as t_sched                  # noqa
from repro_torch.runtime import train as t_train                    # noqa

from torch_diff import model_pair, np_of                            # noqa

DENSE = ["starcoder2-3b", "qwen3-8b", "yi-34b", "gemma3-27b",
         "internvl2-1b"]
LOSS_RTOL = 1e-5
GRAD_RMS = 1e-4


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _ref_batch(jcfg, seed: int = 1, seq: int = 16, batch: int = 2,
               step: int = 0) -> dict:
    b = j_batch_at(jcfg, JDataConfig(seed=seed, seq_len=seq,
                                     global_batch=batch), step)
    return {k: np.asarray(v) for k, v in b.items()}


def _t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _t_loss_grads(tcfg, tp, batch, remat=True):
    flat = _tree.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    total, metrics = ttfm.loss_fn(tcfg, tp, _t_batch(batch), remat=remat)
    grads = torch.autograd.grad(total, flat)
    return total, metrics, _tree.unflatten(tp, grads)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_reference(arch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    batch = _ref_batch(jcfg)
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, CPU_ENV,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               remat=True), has_aux=True))(jp)
    total, metrics, grads = _t_loss_grads(tcfg, tp, batch)
    loss = float(metrics["loss"].detach())
    assert loss == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(total.detach()) == loss
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = interop.lm_params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a), jg))
    pairs = list(zip(_tree.leaves(grads), _tree.leaves(want)))
    assert len(pairs) == len(_tree.leaves(want)) == len(_tree.leaves(tp))
    worst = max(rel_rms(np_of(g), np_of(w)) for g, w in pairs)
    assert worst <= GRAD_RMS, worst
    for g, _ in pairs:                        # every leaf gets a gradient
        assert g.abs().sum().item() > 0


@pytest.mark.parametrize("arch", DENSE)
def test_remat_on_and_off_give_the_same_bits(arch):
    jcfg, _, tcfg, tp = model_pair(arch, layers=2)
    batch = _ref_batch(jcfg, seed=2)
    on = _t_loss_grads(tcfg, tp, batch, remat=True)
    off = _t_loss_grads(tcfg, tp, batch, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(_tree.leaves(on[2]), _tree.leaves(off[2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# rows 3 and 4: the plain backward versions against jax.grad
# ---------------------------------------------------------------------------
def _assert_grad(got, want):
    got, want = np_of(got), np.asarray(want)
    assert rel_rms(got, want) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("ratio", [1, 2, 4])
@pytest.mark.parametrize("mask", ["causal", "window", "noncausal", "cross"])
def test_attention_bwd_ref_matches_jax_grad(ratio, mask):
    rng = np.random.default_rng(ratio)
    B, Hkv, hd = 2, 2, 64
    Hq = Hkv * ratio
    Sq, Skv = (24, 40) if mask == "cross" else (40, 40)
    causal = mask in ("causal", "window")
    window = 7 if mask == "window" else 0
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(j_attn.flash_attention(q, k, v, causal=causal,
                                              window=window) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = fref.attention_ref(tq, tk, tv, causal=causal, window=window)
    got = fref.attention_bwd_ref(tq, tk, tv, out, torch.from_numpy(g),
                                 causal=causal, window=window)
    for a, b in zip(got, want):
        _assert_grad(a, b)
    # the training forward's LSE and residual, as the bf16 kernel takes
    # them: P from the LSE, D from out + out_lo in float32
    out, lse, lo = fref.attention_ref(tq, tk, tv, causal=causal,
                                      window=window, stats=True)
    got = fref.attention_bwd_ref(tq, tk, tv, out, torch.from_numpy(g),
                                 causal=causal, window=window, lse=lse,
                                 out_lo=lo)
    for a, b in zip(got, want):
        _assert_grad(a, b)


@pytest.mark.parametrize("shape", [(4, 7, 64), (33, 128), (2, 3, 5, 256)])
def test_rmsnorm_bwd_ref_matches_jax_grad(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(j_rms_norm(x, w) * g),
                    argnums=(0, 1))(x, w)
    got = rref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(g))
    for a, b in zip(got, want):
        _assert_grad(a, b)


# ---------------------------------------------------------------------------
# the loss head, the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tied", [False, True])
def test_fused_unembed_xent_matches_reference(tied):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    table = rng.standard_normal((384, 16) if tied else (16, 384)) \
        .astype(np.float32)
    labels = rng.integers(0, 257, (2, 5)).astype(np.int32)
    want = j_sharded.fused_unembed_xent(CPU_ENV, h, table, labels,
                                        transpose_table=tied,
                                        valid_vocab=257)
    got = t_sharded.fused_unembed_xent(
        torch.from_numpy(h), torch.from_numpy(table),
        torch.from_numpy(labels), transpose_table=tied, valid_vocab=257)
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "internvl2-1b"])
def test_train_step_trajectory_matches_reference(arch):
    """4 AdamW steps from the same weights on the reference's batches,
    warm-up 2 of a 10-step cosine, remat on."""
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    j_step = jax.jit(j_train.make_train_step(
        jcfg, CPU_ENV, j_train.TrainConfig(),
        lr_schedule=j_sched.cosine_with_warmup(2, 10)))
    t_step = t_train.make_train_step(
        tcfg, t_train.TrainConfig(),
        lr_schedule=t_sched.cosine_with_warmup(2, 10))
    from repro.optim import adamw as j_adamw
    jo, to = j_adamw.init(jp), t_adamw.init(tp)
    for s in range(4):
        batch = _ref_batch(jcfg, seed=3, step=s)
        jp, jo, jm = j_step(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tp, to, tm = t_step(tp, to, _t_batch(batch))
        assert set(tm) == set(jm) == {"loss", "aux", "total", "grad_norm"}
        for key in ("loss", "total", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-4), (s, key)
    assert int(to.step) == 4
