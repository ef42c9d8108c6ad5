"""The port's optimizer (``repro_torch.optim``) against the JAX
package's on the same numpy inputs.

Tolerances:

* AdamW in float32: 1e-6 relative on the global norm, and on the new
  parameters and both moments elementwise, with an absolute floor of
  1e-6 of the tensor's largest magnitude.  The port rounds each float32
  op on its own, as XLA does, but sums the squares of a leaf in another
  order, so the global norm, and with it the clip factor, move by ~1e-7;
  a moment that an update cancels down to a small value carries that
  error, ~1e-7 of its terms, which can be 1e-5 of itself.
* AdamW on bfloat16 parameters: the new parameters within one bf16 ulp
  (both round float32 values that agree to 1e-6 relative; a value on a
  rounding boundary may go either way), the float32 moments to 1e-6.
* Schedules: 1e-7 absolute (float32 math, the same ops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as j_adamw                          # noqa
from repro.optim import schedules as j_sched                      # noqa
from repro_torch import _tree                                     # noqa
from repro_torch.optim import adamw as t_adamw                    # noqa
from repro_torch.optim import schedules as t_sched                # noqa

RTOL = 1e-6
SHAPES = {"embed": (40, 12), "layers": [{"w": (12, 3, 4), "ln": (12,)},
                                        {"w": (12, 3, 4), "ln": (12,)}],
          "head": (12, 40)}


def _map_shapes(fn, dtype):
    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return fn(t)
    tree = go(SHAPES)
    if dtype == "bfloat16":
        tree = _tree.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    return tree


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_jax(tree):
    return _tree.tree_map(jnp.asarray, tree)


def _np(t):
    return t.detach().float().numpy() if hasattr(t, "detach") \
        else np.asarray(t, np.float32)


def _close(got, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    ia = a.view(torch.int16).int()
    ib = b.view(torch.int16).int()
    return int((ia - ib).abs().max().item())


def _run(dtype, grad_scale, grad_clip, steps, seed=0):
    """Run ``steps`` AdamW updates in both packages on the same params and
    per-step grads; returns the trees of both and the grad norms."""
    rng = np.random.default_rng(seed)
    params = _map_shapes(lambda s: rng.standard_normal(s)
                         .astype(np.float32), dtype)
    grads = [_map_shapes(lambda s: (rng.standard_normal(s) * grad_scale)
                         .astype(np.float32), dtype) for _ in range(steps)]
    cfg_kw = dict(lr=1e-2, grad_clip=grad_clip)
    jcfg, tcfg = j_adamw.AdamWConfig(**cfg_kw), t_adamw.AdamWConfig(**cfg_kw)
    jp = _to_jax(params)
    js = j_adamw.init(jp)
    tp = _tree.tree_map(_to_torch, params)
    ts = t_adamw.init(tp)
    norms = []
    for i, g in enumerate(grads):
        scale = 0.5 + 0.25 * i
        jp, js, jm = j_adamw.update(jcfg, _to_jax(g), js, jp, lr_scale=scale)
        tp_new, ts, tm = t_adamw.update(tcfg, _tree.tree_map(_to_torch, g),
                                        ts, tp, lr_scale=scale)
        assert tp_new is tp                       # in place
        norms.append((float(jm["grad_norm"]), float(tm["grad_norm"])))
    return jp, js, tp, ts, norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clip", [(3.0, 1.0), (1e-3, 1.0),
                                             (3.0, 0.0)],
                         ids=["clip-active", "clip-inactive", "no-clip"])
def test_adamw_update_matches_reference(dtype, grad_scale, clip):
    jp, js, tp, ts, norms = _run(dtype, grad_scale, clip, steps=3)
    for jn, tn in norms:
        assert tn == pytest.approx(jn, rel=RTOL)
    if clip > 0:                   # the clip is active iff the norm > 1
        assert all((jn > clip) == (grad_scale > 1) for jn, _ in norms)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    for name, jt, tt in (("m", js.m, ts.m), ("v", js.v, ts.v)):
        for a, b in zip(jax.tree.leaves(jt), _tree.leaves(tt)):
            assert b.dtype == torch.float32
            _close(b, a, name)
    for a, b in zip(jax.tree.leaves(jp), _tree.leaves(tp)):
        if dtype == "float32":
            _close(b, a, "params")
        else:
            assert b.dtype == torch.bfloat16
            assert _ulps(b, _to_torch(a)) <= 1


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _map_shapes(lambda s: rng.standard_normal(s).astype(np.float32),
                       "float32")
    j = float(j_adamw.global_norm(_to_jax(tree)))
    t = float(t_adamw.global_norm(_tree.tree_map(_to_torch, tree)))
    assert t == pytest.approx(j, rel=RTOL)


def test_init_is_float32_zeros_beside_each_leaf():
    tp = _tree.tree_map(_to_torch, _map_shapes(
        lambda s: np.ones(s, np.float32), "bfloat16"))
    st = t_adamw.init(tp)
    assert int(st.step) == 0
    for p, m, v in zip(_tree.leaves(tp), _tree.leaves(st.m),
                       _tree.leaves(st.v)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert m.data_ptr() != v.data_ptr()
        assert not m.any() and not v.any()


@pytest.mark.parametrize("warmup,total,min_frac", [(2, 10, 0.1),
                                                   (10, 200, 0.1),
                                                   (0, 5, 0.0),
                                                   (25, 30, 0.3)])
def test_cosine_with_warmup_matches_reference(warmup, total, min_frac):
    js = j_sched.cosine_with_warmup(warmup, total, min_frac)
    ts = t_sched.cosine_with_warmup(warmup, total, min_frac)
    for step in range(total + 6):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, step


def test_constant_schedule():
    assert t_sched.constant()(7) == j_sched.constant()(7) == 1.0
