"""The port's chain-CNN executor (``repro_torch.models.chain_cnn``)
against the JAX package's, from the same numpy weights and images, in
float32 on the CPU: NiN, YOLOv2 and VGG16 at every split, the layer
shapes, and what the planner prices against what a split ships.

Tolerances: activations and logits to rtol 1e-4 / atol 1e-5 (the same
float32 convolutions and products summed in another order; the largest
difference seen is ~4e-7 on outputs of ~0.2); split execution equal to
unsplit execution in the port bit for bit (the same operations on the
same tensors); shapes and element counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import chain_cnns as jcnn                        # noqa
from repro.core.profile import profile_chain_cnn as j_profile       # noqa
from repro.models import chain_cnn as jexec                         # noqa
from repro_torch import interop                                     # noqa
from repro_torch.configs import chain_cnns as tcnn                  # noqa
from repro_torch.core.profile import profile_chain_cnn as t_profile  # noqa
from repro_torch.models import chain_cnn as texec                   # noqa

NETS = ("nin", "yolov2", "vgg16")


def _pair(name, seed=0, batch=2):
    jcfg, tcfg = getattr(jcnn, name)(), getattr(tcnn, name)()
    jp = jexec.init_cnn(jcfg, jax.random.PRNGKey(seed))
    tp = interop.cnn_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).standard_normal(
        (batch, jcfg.in_hw, jcfg.in_hw, jcfg.in_ch)).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", NETS)
def test_every_split_matches_reference(name):
    """split_inference at every s in 0..M: the port's (inter, out)
    against the reference's, and against the port's own unsplit forward
    bit for bit."""
    jcfg, jp, tcfg, tp, x = _pair(name)
    xt = torch.from_numpy(x)
    full = texec.forward(tcfg, tp, xt)
    _close(full, jexec.forward(jcfg, jp, jnp.asarray(x)), "forward")
    for s in range(tcfg.num_layers + 1):
        inter, out = texec.split_inference(tcfg, tp, xt, s)
        j_inter, j_out = jexec.split_inference(jcfg, jp, jnp.asarray(x), s)
        assert tuple(inter.shape) == j_inter.shape
        _close(inter, j_inter, f"split {s} inter")
        _close(out, j_out, f"split {s} out")
        assert torch.equal(out, full), f"split {s} != unsplit"


@pytest.mark.parametrize("name", NETS)
def test_forward_range_matches_reference_layer_by_layer(name):
    """Each layer alone from the reference's own input activation, so an
    error cannot hide behind a later ReLU."""
    jcfg, jp, tcfg, tp, x = _pair(name, seed=1)
    h = jnp.asarray(x)
    for i in range(jcfg.num_layers):
        got = texec.forward_range(tcfg, tp, torch.from_numpy(np.array(h)),
                                  i, i + 1)
        h = jexec.forward_range(jcfg, jp, h, i, i + 1)
        _close(got, h, f"layer {i} ({jcfg.layers[i].kind})")


@pytest.mark.parametrize("name", NETS)
def test_shipped_elements_match_the_profile(name):
    """What split s ships per image equals what the planner prices:
    out_bits[s-1] / 16 elements (bf16 bits), in_bits / 8 at s = 0 (a
    uint8 image), for every shipped config; _layer_shapes is the
    reference's."""
    tcfg, jcfg = getattr(tcnn, name)(), getattr(jcnn, name)()
    assert texec._layer_shapes(tcfg) == jexec._layer_shapes(jcfg)
    prof = t_profile(tcfg)
    tp = texec.init_cnn(tcfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((1, tcfg.in_hw, tcfg.in_hw, tcfg.in_ch))
    for s in range(tcfg.num_layers + 1):
        inter = texec.forward_range(tcfg, tp, x, 0, s)
        want = prof.in_bits / 8 if s == 0 else prof.out_bits[s - 1] / 16
        assert inter[0].numel() == want, f"split {s}"


def test_init_cnn_layout_and_seed():
    cfg = tcnn.nin()
    a = texec.init_cnn(cfg, torch.Generator().manual_seed(3), "cpu")
    b = texec.init_cnn(cfg, torch.Generator().manual_seed(3), "cpu")
    w = a[0]["w"]
    assert tuple(w.shape) == (192, 3, 5, 5)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w, b[0]["w"])
    assert abs(w.std().item() - (5 * 5 * 3) ** -0.5) < 0.01
    assert float(a[0]["b"].abs().sum()) == 0.0
    vgg = texec.init_cnn(tcnn.vgg16(), torch.Generator().manual_seed(0),
                         "cpu")
    assert tuple(vgg[18]["w"].shape) == (512, 4096)


def test_odd_pool_size_disagreement_is_the_references():
    """At an odd size the reference disagrees with itself: its
    ``apply_layer`` (``reduce_window`` with SAME) gives ceil(H/2), while
    its ``_layer_shapes`` and ``profile_chain_cnn`` count H // 2.  The
    port copies both as they are (ROADMAP §3).  No fc layer: the
    reference's ``init_cnn`` would size one by the floor and its product
    would fail."""
    layers = lambda m: (m.CNNLayer("conv", out_ch=8, kernel=3, stride=1),  # noqa
                        m.CNNLayer("pool", kernel=2, stride=2),
                        m.CNNLayer("conv", out_ch=4, kernel=5, stride=2),
                        m.CNNLayer("pool", kernel=3, stride=2))
    jcfg = jcnn.ChainCNNConfig(name="odd", family="cnn", in_hw=33,
                               layers=layers(jcnn))
    tcfg = tcnn.ChainCNNConfig(name="odd", family="cnn", in_hw=33,
                               layers=layers(tcnn))
    jp = jexec.init_cnn(jcfg, jax.random.PRNGKey(0))
    tp = interop.cnn_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).standard_normal(
        (2, 33, 33, 3)).astype(np.float32)
    h, t = jnp.asarray(x), torch.from_numpy(x)
    run_hw = []
    for i in range(4):
        h = jexec.forward_range(jcfg, jp, h, i, i + 1)
        t = texec.forward_range(tcfg, tp, t, i, i + 1)
        _close(t, h, f"layer {i}")
        run_hw.append(h.shape[1])
    assert run_hw == [33, 17, 9, 5]                  # ceil at every layer
    counted = [sh[0] for sh in jexec._layer_shapes(jcfg)]
    assert counted == [33, 16, 8, 4]                 # floor at the pools
    assert [sh[0] for sh in texec._layer_shapes(tcfg)] == counted
    jprof, tprof = j_profile(jcfg), t_profile(tcfg)
    np.testing.assert_array_equal(tprof.out_bits, jprof.out_bits)
    assert tprof.out_bits[1] == 16 * 16 * 8 * 16     # H // 2, not 17
