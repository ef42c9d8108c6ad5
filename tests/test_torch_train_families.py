"""Training for the MoE, RWKV-6, RecurrentGemma and encoder-decoder
families: the port's ``loss_fn``, its remat and ``make_train_step``
against the JAX package's on the same weights and batches, the plain
backward versions of kernel rows 5, 6 and 7 (and row 3's at head_dim
256) against ``jax.grad`` of the reference's jnp functions, and the
launcher on every family.

Weights, batches and tolerances are those of ``test_torch_train.py``:
the reference's ``init_lm`` (norm weights randomised) and ``batch_at``
as numpy, all in float32; the loss and the MoE aux to 1e-5 relative,
every gradient leaf to 1e-4 in error RMS over the reference's RMS; the
plain backward versions to 1e-5 in error RMS and 1e-4 elementwise
(relative, with an absolute floor of 1e-5 of the largest gradient).
Before the MoE losses are compared, both packages' routing (each top-k
expert and whether capacity keeps it) is compared on each block's own
input; a token whose k-th and (k+1)-th gates lie within 1e-6 would be
named as a near-tie (none occurs at these seeds).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gemm import ref as j_moe_ref                 # noqa
from repro.kernels.rglru import ref as j_rglru_ref                  # noqa
from repro.models import attention as j_attn                        # noqa
from repro.models import moe as j_moe                               # noqa
from repro.models import rwkv as j_rwkv                             # noqa
from repro.models import transformer as jtfm                        # noqa
from repro.optim import adamw as j_adamw                            # noqa
from repro.optim import schedules as j_sched                        # noqa
from repro.runtime import train as j_train                          # noqa
from repro.runtime.data import DataConfig as JDataConfig            # noqa
from repro.runtime.data import batch_at as j_batch_at               # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch import _tree, interop                              # noqa
from repro_torch.kernels.flash_attention import ref as fref         # noqa
from repro_torch.kernels.moe_gemm import ref as t_moe_ref           # noqa
from repro_torch.kernels.rglru import ref as t_rglru_ref            # noqa
from repro_torch.kernels.wkv6 import ref as t_wkv_ref               # noqa
from repro_torch.launch import train as t_launch                    # noqa
from repro_torch.models import moe as t_moe                         # noqa
from repro_torch.models import transformer as ttfm                  # noqa
from repro_torch.optim import adamw as t_adamw                      # noqa
from repro_torch.optim import schedules as t_sched                  # noqa
from repro_torch.runtime import train as t_train                    # noqa

from torch_diff import model_pair, np_of                            # noqa

FAMILIES = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "rwkv6-3b",
            "recurrentgemma-9b", "seamless-m4t-large-v2"]
MOE = FAMILIES[:2]
LOSS_RTOL = 1e-5
GRAD_RMS = 1e-4
GATE_TIE = 1e-6


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


def _j_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t_loss_grads(tcfg, tp, batch, remat=True):
    flat = _tree.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    total, metrics = ttfm.loss_fn(tcfg, tp, _t_batch(batch), remat=remat)
    grads = torch.autograd.grad(total, flat)
    return total, metrics, _tree.unflatten(tp, grads)


# ---------------------------------------------------------------------------
# routing: both packages pick the same experts and keep the same ones
# ---------------------------------------------------------------------------
def _keep(idx: np.ndarray, E: int, capacity: int) -> np.ndarray:
    """Whether capacity keeps each (token, slot) assignment: its rank in
    token order among its expert's assignments is below ``capacity``."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=E)
    offsets = np.cumsum(counts) - counts
    rank = np.empty_like(flat)
    rank[order] = np.arange(flat.size) - offsets[flat[order]]
    return (rank < capacity).reshape(idx.shape)


def _record_routing(monkeypatch, module, top_k_fn):
    """Wrap ``module._moe_local`` to record, for each call, its top-k
    experts, sorted gates and keep mask, computed by that package's own
    ops on the call's own inputs."""
    seen, inner = [], module._moe_local

    def spy(x_flat, router, *a, num_experts, top_k, capacity, **kw):
        idx, gates = top_k_fn(x_flat, router, num_experts)
        seen.append((idx[:, :top_k], gates, _keep(idx[:, :top_k],
                                                  num_experts, capacity)))
        return inner(x_flat, router, *a, num_experts=num_experts,
                     top_k=top_k, capacity=capacity, **kw)

    monkeypatch.setattr(module, "_moe_local", spy)
    return seen


def _t_top(x_flat, router, E):
    gates = torch.softmax(x_flat.detach().float() @ router.detach(), -1)
    g, idx = torch.topk(gates, E, dim=-1)
    return idx.numpy(), g.numpy()


def _j_top(x_flat, router, E):
    gates = jax.nn.softmax(x_flat.astype(jnp.float32) @ router, axis=-1)
    g, idx = jax.lax.top_k(gates, E)
    return np.asarray(idx), np.asarray(g)


def _assert_same_routing(port: list, ref: list, top_k: int) -> None:
    assert len(port) == len(ref) > 0
    for layer, ((ti, tg, tk), (ji, jg, jk)) in enumerate(zip(port, ref)):
        gap = jg[:, top_k - 1] - jg[:, top_k]
        ties = np.flatnonzero(gap <= GATE_TIE * jg[:, top_k - 1])
        assert not ties.size, (f"block {layer}: near-ties at tokens "
                               f"{ties.tolist()}")
        np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1),
                                      err_msg=f"block {layer} experts")
        np.testing.assert_array_equal(tk, jk,
                                      err_msg=f"block {layer} keep mask")


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_matches_reference(arch, monkeypatch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    batch = _ref_batch(jcfg)
    port = _record_routing(monkeypatch, t_moe, _t_top)
    ref = _record_routing(monkeypatch, j_moe, _j_top)
    with torch.no_grad():
        ttfm.loss_fn(tcfg, tp, _t_batch(batch), remat=False)
    with jax.disable_jit():
        jtfm.loss_fn(jcfg, jp, CPU_ENV, _j_batch(batch), remat=False)
    assert len(port) == tcfg.num_layers
    _assert_same_routing(port, ref, tcfg.experts_per_token)


# ---------------------------------------------------------------------------
# loss_fn, remat, the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    batch = _ref_batch(jcfg)
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, CPU_ENV, _j_batch(batch),
                               remat=True), has_aux=True))(jp)
    total, metrics, grads = _t_loss_grads(tcfg, tp, batch)
    assert float(metrics["loss"].detach()) == pytest.approx(
        float(jm["loss"]), rel=LOSS_RTOL)
    assert float(total.detach()) == pytest.approx(float(jt), rel=LOSS_RTOL)
    if tcfg.num_experts:
        assert float(jm["aux"]) > 0
        assert float(metrics["aux"].detach()) == pytest.approx(
            float(jm["aux"]), rel=LOSS_RTOL)
    else:
        assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = interop.lm_params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a), jg))
    pairs = list(zip(_tree.leaves(grads), _tree.leaves(want)))
    assert len(pairs) == len(_tree.leaves(want)) == len(_tree.leaves(tp))
    worst = max(rel_rms(np_of(g), np_of(w)) for g, w in pairs)
    assert worst <= GRAD_RMS, worst
    for g, _ in pairs:                        # every leaf gets a gradient
        assert g.abs().sum().item() > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_and_off_give_the_same_bits(arch):
    jcfg, _, tcfg, tp = model_pair(arch, layers=2)
    batch = _ref_batch(jcfg, seed=2)
    on = _t_loss_grads(tcfg, tp, batch, remat=True)
    off = _t_loss_grads(tcfg, tp, batch, remat=False)
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[1]["aux"], off[1]["aux"])
    for a, b in zip(_tree.leaves(on[2]), _tree.leaves(off[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b"])
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
    jo, to = j_adamw.init(jp), t_adamw.init(tp)
    for s in range(4):
        batch = _ref_batch(jcfg, seed=3, step=s)
        jp, jo, jm = j_step(jp, jo, _j_batch(batch))
        tp, to, tm = t_step(tp, to, _t_batch(batch))
        assert set(tm) == set(jm) == {"loss", "aux", "total", "grad_norm"}
        for key in ("loss", "aux", "total", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-4), (s, key)
    assert int(to.step) == 4


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_every_family_on_the_cpu(arch):
    out = t_launch.run(t_launch.parse_args(
        ["--arch", arch, "--size", "smoke", "--steps", "2", "--seq", "16",
         "--batch", "2", "--device", "cpu"]))
    assert sorted(out["losses"]) == [0, 1]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert all(np.isfinite(v) and v > 0 for v in out["grad_norms"].values())


def test_the_port_loads_no_jax_in_a_fresh_interpreter():
    """Training every family imports nothing of JAX or the JAX package."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import train\n"
        "for a in ('granite-moe-1b-a400m', 'rwkv6-3b', 'recurrentgemma-9b',"
        " 'seamless-m4t-large-v2'):\n"
        "    train.run(train.parse_args(['--arch', a, '--steps', '1',"
        " '--seq', '8', '--batch', '1', '--device', 'cpu']))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


# ---------------------------------------------------------------------------
# the plain backward versions against jax.grad
# ---------------------------------------------------------------------------
def _assert_grad(got, want):
    got, want = np_of(got), np.asarray(want)
    assert rel_rms(got, want) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("E,C,d,ff", [(4, 24, 64, 128), (2, 5, 40, 24)])
def test_moe_swiglu_bwd_ref_matches_jax_grad(E, C, d, ff):
    rng = np.random.default_rng(E * C)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, d, ff)).astype(np.float32)
              / np.sqrt(d) for _ in range(2))
    wd = rng.standard_normal((E, ff, d)).astype(np.float32) / np.sqrt(ff)
    g = rng.standard_normal((E, C, d)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_moe_ref.moe_swiglu_ref(*a) * g),
                    argnums=(0, 1, 2, 3))(x, wg, wu, wd)
    got = t_moe_ref.moe_swiglu_bwd_ref(
        *(torch.from_numpy(a) for a in (x, wg, wu, wd, g)))
    for a, b in zip(got, want):
        _assert_grad(a, b)


@pytest.mark.parametrize("a_kind", ["uniform", "near_one", "near_zero"])
def test_rglru_scan_bwd_ref_matches_jax_grad(a_kind):
    rng = np.random.default_rng(7)
    B, S, C = 2, 33, 24
    u = rng.random((B, S, C)).astype(np.float32)
    a = {"uniform": u, "near_one": 1.0 - 1e-3 * u,
         "near_zero": 1e-3 * u}[a_kind].astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    g = rng.standard_normal((B, S, C)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(j_rglru_ref.rglru_scan_ref(a, b)
                                         * g), argnums=(0, 1))(a, b)
    h = t_rglru_ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    got = t_rglru_ref.rglru_scan_bwd_ref(torch.from_numpy(a), h,
                                         torch.from_numpy(g))
    for x, y in zip(got, want):
        _assert_grad(x, y)


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_bwd_ref_matches_jax_grad(with_s0):
    """With w = 0 and w = 1 entries (the model's clamp reaches both in
    float32), from zero or from a state, and the final state's gradient
    too when there is a state."""
    rng = np.random.default_rng(11)
    B, S, H, n = 2, 13, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, n)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.random((B, S, H, n)).astype(np.float32)
    w[..., ::5] = 0.0
    w[..., 2::7] = 1.0
    u = rng.standard_normal((H, n)).astype(np.float32)
    s0 = rng.standard_normal((B, H, n, n)).astype(np.float32)
    gy = rng.standard_normal((B, S, H, n)).astype(np.float32)
    gs = rng.standard_normal((B, H, n, n)).astype(np.float32)

    def f(r, k, v, w, u, s0):
        y, s = j_rwkv.wkv6_scan(r, k, v, w, u, s0 if with_s0 else None)
        out = jnp.sum(y * gy)
        return out + jnp.sum(s * gs) if with_s0 else out

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4, 5))(r, k, v, w, u, s0)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    got = t_wkv_ref.wkv6_bwd_ref(
        *t, torch.from_numpy(s0) if with_s0 else None, torch.from_numpy(gy),
        torch.from_numpy(gs) if with_s0 else None)
    assert (got[5] is None) != with_s0
    for a, b in zip(got[:5], want[:5]):
        _assert_grad(a, b)
    if with_s0:
        _assert_grad(got[5], want[5])


@pytest.mark.parametrize("mask", ["causal", "window", "noncausal"])
def test_attention_bwd_ref_at_head_dim_256_matches_jax_grad(mask):
    """recurrentgemma-9b's head_dim, 4/1 heads, from the training
    forward's LSE and residual as the kernels take them."""
    rng = np.random.default_rng(13)
    B, S, Hq, Hkv, hd = 2, 24, 4, 1, 256
    causal, window = mask != "noncausal", 7 if mask == "window" else 0
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32) + 2.0
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(j_attn.flash_attention(q, k, v, causal=causal,
                                              window=window) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse, lo = fref.attention_ref(tq, tk, tv, causal=causal,
                                      window=window, stats=True)
    got = fref.attention_bwd_ref(tq, tk, tv, out, torch.from_numpy(g),
                                 causal=causal, window=window, lse=lse,
                                 out_lo=lo)
    for a, b in zip(got, want):
        _assert_grad(a, b)
