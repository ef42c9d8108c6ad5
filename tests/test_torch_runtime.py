"""The port's training runtime (``repro_torch.runtime``,
``repro_torch.launch.train``, ``examples/torch_train_100m.py``): the
twins of tests/test_runtime.py's checkpoint, data and resume tests, and
the host-side pieces held against the JAX package bit for bit (the
straggler dispatcher, int8 gradient quantization).  Everything runs on
the CPU."""
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config                # noqa
from repro.configs import reduced as j_reduced                      # noqa
from repro.runtime import compression as j_comp                     # noqa
from repro.runtime import data as j_data                            # noqa
from repro_torch import _tree                                       # noqa
from repro_torch.configs import get_config, reduced                 # noqa
from repro_torch.launch import train as t_launch                    # noqa
from repro_torch.models import transformer as ttfm                  # noqa
from repro_torch.optim import adamw                                 # noqa
from repro_torch.runtime import checkpoint as ckpt                  # noqa
from repro_torch.runtime import compression as t_comp               # noqa
from repro_torch.runtime import data as t_data                      # noqa
from repro_torch.runtime.train import TrainConfig, make_train_step  # noqa

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_state():
    """A reduced qwen3-8b in bf16 with a non-trivial AdamW state."""
    cfg = reduced(get_config("qwen3-8b"))
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw.init(params)
    step = make_train_step(cfg)
    batch = t_data.batch_at(cfg, t_data.DataConfig(seq_len=16,
                                                   global_batch=2), 0, "cpu")
    params, opt, _ = step(params, opt, batch)
    return cfg, params, opt


def _fresh(cfg):
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(9), "cpu")
    return params, adamw.init(params)


def _rng(seed):
    return torch.Generator().manual_seed(seed).get_state()


def _state(params, opt, step):
    return ckpt.TrainState(step=step, params=params, opt_state=opt,
                           data_cursor=step, rng=_rng(step))


def _same(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoint: atomic, restart-safe, retention
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path, small_state):
    cfg, params, opt = small_state
    state = ckpt.TrainState(step=7, params=params, opt_state=opt,
                            data_cursor=7, rng=_rng(3))
    path = ckpt.save(str(tmp_path), state)
    manifest = json.loads(Path(path, "manifest.json").read_text())
    assert "bfloat16" in manifest["dtypes"] and "float32" in \
        manifest["dtypes"]
    arrays = np.load(Path(path, "arrays.npz"))
    for i, dt in enumerate(manifest["dtypes"]):     # bf16 as its uint16 view
        assert (arrays[f"leaf_{i}"].dtype == np.uint16) == (dt == "bfloat16")
    example_p, example_o = _fresh(cfg)
    restored = ckpt.restore(str(tmp_path), _state(example_p, example_o, 0))
    assert restored is not None
    assert restored.step == 7 and restored.data_cursor == 7
    assert torch.equal(restored.rng, _rng(3))
    _same(restored.params, params)
    _same(restored.opt_state, opt)
    assert int(restored.opt_state.step) == 1


def test_checkpoint_corrupt_newest_falls_back(tmp_path, small_state):
    cfg, params, opt = small_state
    for step in (1, 2):
        ckpt.save(str(tmp_path), _state(params, opt, step))
    path = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(path, "wb") as f:
        f.write(b"garbage")
    restored = ckpt.restore(str(tmp_path), _state(*_fresh(cfg), 0))
    assert restored is not None and restored.step == 1


def test_checkpoint_staging_dir_is_invisible(tmp_path, small_state):
    cfg, params, opt = small_state
    ckpt.save(str(tmp_path), _state(params, opt, 1))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000005.tmp"))
    assert ckpt.list_steps(str(tmp_path)) == [1]
    assert ckpt.restore(str(tmp_path), _state(*_fresh(cfg), 0)).step == 1


def test_checkpoint_retention(tmp_path, small_state):
    cfg, params, opt = small_state
    for step in range(6):
        ckpt.save(str(tmp_path), _state(params, opt, step), retain=3)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4, 5]


def test_checkpoint_restores_onto_the_example_dtype(tmp_path, small_state):
    cfg, params, opt = small_state
    ckpt.save(str(tmp_path), _state(params, opt, 1))
    ex_p = _tree.tree_map(lambda t: t.float(), _fresh(cfg)[0])
    restored = ckpt.restore(str(tmp_path), _state(ex_p, adamw.init(ex_p),
                                                  0))
    for a, b in zip(_tree.leaves(restored.params), _tree.leaves(params)):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())


def test_train_resume_bit_identical(tmp_path):
    """Train 4 steps; train 2 + checkpoint + resume 2: the same loss, bit
    for bit (on the CPU every op is deterministic)."""
    cfg = reduced(get_config("starcoder2-3b"))
    dcfg = t_data.DataConfig(seed=1, seq_len=32, global_batch=2)
    step_fn = make_train_step(cfg, TrainConfig(remat=False))

    p, o = _fresh(cfg)
    for s in range(4):
        p, o, m = step_fn(p, o, t_data.batch_at(cfg, dcfg, s, "cpu"))
    straight = float(m["loss"])

    p, o = _fresh(cfg)
    for s in range(2):
        p, o, _ = step_fn(p, o, t_data.batch_at(cfg, dcfg, s, "cpu"))
    ckpt.save(str(tmp_path), _state(p, o, 2))
    restored = ckpt.restore(str(tmp_path), _state(*_fresh(cfg), 0))
    p, o = restored.params, restored.opt_state
    for s in range(restored.data_cursor, 4):
        p, o, m = step_fn(p, o, t_data.batch_at(cfg, dcfg, s, "cpu"))
    assert float(m["loss"]) == straight


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-8b", "internvl2-1b",
                                  "seamless-m4t-large-v2"])
def test_batch_at_shapes_dtypes_and_determinism(arch):
    cfg = reduced(get_config(arch))
    jcfg = j_reduced(j_get_config(arch))
    dcfg = t_data.DataConfig(seed=3, seq_len=64, global_batch=4)
    b1 = t_data.batch_at(cfg, dcfg, 11, "cpu")
    b2 = t_data.batch_at(cfg, dcfg, 11, "cpu")
    b3 = t_data.batch_at(cfg, dcfg, 12, "cpu")
    ref = j_data.batch_at(jcfg, j_data.DataConfig(seed=3, seq_len=64,
                                                  global_batch=4), 11)
    assert set(b1) == set(ref)
    for k, v in ref.items():
        assert tuple(b1[k].shape) == tuple(v.shape), k
        assert str(b1[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].min()) >= 0
    assert int(b1["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    other = t_data.batch_at(cfg, t_data.DataConfig(seed=4, seq_len=64,
                                                   global_batch=4), 11,
                            "cpu")
    assert not torch.equal(b1["tokens"], other["tokens"])


def test_batch_at_follows_the_reference_law():
    """The same Zipf-ish law: the token histograms of many batches agree
    with the reference's to a few percent in the head of the law."""
    cfg = reduced(get_config("qwen3-8b"))
    jcfg = j_reduced(j_get_config("qwen3-8b"))
    dcfg = t_data.DataConfig(seed=0, seq_len=256, global_batch=8)
    jd = j_data.DataConfig(seed=0, seq_len=256, global_batch=8)
    t = np.concatenate([t_data.batch_at(cfg, dcfg, s, "cpu")["tokens"]
                        .numpy().ravel() for s in range(8)])
    j = np.concatenate([np.asarray(j_data.batch_at(jcfg, jd, s)["tokens"])
                        .ravel() for s in range(8)])
    ht = np.bincount(t, minlength=cfg.vocab_size) / t.size
    hj = np.bincount(j, minlength=cfg.vocab_size) / j.size
    assert abs(ht[0] - hj[0]) < 0.02 and abs(ht[-1] - hj[-1]) < 0.02
    assert abs(t.mean() - j.mean()) < 0.05 * j.mean()


def test_batch_at_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_data.batch_at(reduced(get_config("qwen3-8b")),
                        t_data.DataConfig(), 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_dispatcher_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    hosts, mb = 8, 32
    j = j_data.StragglerAwareDispatcher(hosts, mb)
    t = t_data.StragglerAwareDispatcher(hosts, mb)
    for step in range(40):
        lat = rng.uniform(0.5, 3.0, hosts)
        for h in range(hosts):
            j.report(h, lat[h])
            t.report(h, lat[h])
        if step == 10:
            j.mark_dead(3), t.mark_dead(3)
        if step == 25:
            j.mark_alive(3), t.mark_alive(3)
        a, b = j.assignment(), t.assignment()
        np.testing.assert_array_equal(a, b)
        assert a.sum() == mb
        np.testing.assert_array_equal(j.latency, t.latency)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1000,), (3, 7, 64), (256,), (5,)])
def test_quantize_int8_matches_reference(shape):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * np.float32(3.0)).astype(np.float32)
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    tq, ts = t_comp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = t_comp.dequantize_int8(tq, ts, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_comp.dequantize_int8(jq, js, shape)))
    assert np.abs(back.numpy() - x).max() <= ts.max().item() / 2 + 1e-6


# ---------------------------------------------------------------------------
# the launcher and the example, as a user runs them
# ---------------------------------------------------------------------------
def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss ([0-9.]+)", out)}


def test_launcher_preempts_resumes_and_matches_straight_through(tmp_path):
    cmd = ["-m", "repro_torch.launch.train", "--device", "cpu", "--size",
           "smoke", "--steps", "4", "--seq", "32", "--batch", "2",
           "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    first = _run(cmd + ["--stop-after", "2", "--resume"], tmp_path)
    assert "[preempt] stopping after 2 steps" in first
    assert sorted(_losses(first)) == [0, 1]
    second = _run(cmd + ["--resume"], tmp_path)
    assert "[resume] restored step 2, data cursor 2" in second
    assert sorted(_losses(second)) == [2, 3] and "done: 2 steps" in second
    straight = t_launch.run(t_launch.parse_args(cmd[2:-4]))
    resumed = {**_losses(first), **_losses(second)}
    assert resumed == {s: float(f"{v:.4f}")
                       for s, v in straight["losses"].items()}


def test_example_trains_preempts_and_resumes(capsys):
    example = runpy.run_path(str(ROOT / "examples" / "torch_train_100m.py"))
    example["main"](["--device", "cpu", "--size", "smoke", "--steps", "4",
                     "--seq", "32", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[preempt] stopping after 2 steps" in out
    assert "[resume] restored step 2, data cursor 2" in out
    assert "done: 2 steps" in out
