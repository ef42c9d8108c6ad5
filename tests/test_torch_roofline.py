"""The port's roofline and collective statistics (``launch/roofline.py``,
``launch/collective_stats.py``), ``num_active_params`` and the ten
per-arch config modules against the JAX package's, in one process
(``repro.launch.dryrun`` is never imported here: it forces 512 host
devices when imported).

* ``num_active_params`` and the five roofline formulas for every
  architecture x cell x both production layouts' (tp, dp) x KV element
  bytes 2.0 and 1.25: equal floats (``==``);
* ``_ring_factor`` for every collective kind x group size 1..512: equal;
* ``derive`` at the reference's TPU v5e constants: the reference's
  ``Roofline`` field for field, its step time and MFU;
* ``collect_stats`` of a hand-built record: hand-computed totals;
* ``make_production_mesh``: the reference's axes and sizes;
* each ``repro_torch.configs.<arch>.CONFIG``: ``get_config(<id>)`` and,
  field by field, the reference module's ``CONFIG``.
"""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_CELLS as REF_CELLS                  # noqa: E402
from repro.configs import get_config as ref_get_config            # noqa: E402
from repro.launch import hlo_stats as ref_stats                   # noqa: E402
from repro.launch import mesh as ref_mesh                         # noqa: E402
from repro.launch import roofline as ref_rl                       # noqa: E402
from repro_torch.configs import ALL_CELLS, ARCH_IDS, get_config   # noqa: E402
from repro_torch.launch import collective_stats as t_stats        # noqa: E402
from repro_torch.launch import roofline as t_rl                   # noqa: E402
from repro_torch.launch.mesh import make_production_mesh          # noqa: E402

#: (tp, dp) of data 16 x model 16 and pod 2 x data 16 x model 16
LAYOUTS = ((16, 16, 256), (16, 32, 512))
MODULES = {
    "gemma3-27b": "gemma3_27b", "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internvl2-1b": "internvl2_1b", "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-8b": "qwen3_8b", "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-3b": "rwkv6_3b", "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "starcoder2-3b": "starcoder2_3b", "yi-34b": "yi_34b"}


def _pair(arch):
    return get_config(arch), ref_get_config(arch)


def test_the_module_table_names_every_architecture():
    assert sorted(MODULES) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_num_active_params_and_the_roofline_formulas_equal_the_reference(
        arch):
    cfg, ref = _pair(arch)
    assert cfg.num_params() == ref.num_params()
    assert cfg.num_active_params() == ref.num_active_params()
    assert t_rl.matmul_params(cfg) == ref_rl.matmul_params(ref)
    assert t_rl.body_and_unembed_params(cfg) == \
        ref_rl.body_and_unembed_params(ref)
    for cell, rcell in zip(ALL_CELLS, REF_CELLS):
        assert cell.name == rcell.name
        assert t_rl.model_flops(cfg, cell) == ref_rl.model_flops(ref, rcell)
        for kvb in (2.0, 1.25):
            for B, L in ((cell.global_batch, cell.seq_len), (1, 4096)):
                assert t_rl.kv_cache_bytes(cfg, B, L, kvb) == \
                    ref_rl.kv_cache_bytes(ref, B, L, kvb)
            for tp, dp, chips in LAYOUTS:
                assert t_rl.analytic_traffic_bytes(
                    cfg, cell, chips, tp, dp, kvb) == \
                    ref_rl.analytic_traffic_bytes(ref, rcell, chips, tp, dp,
                                                  kvb), (cell.name, tp, dp)


def test_ring_factor_equals_the_reference_for_every_kind_and_size():
    for kind in ref_stats.COLLECTIVE_KINDS:
        for n in range(1, 513):
            assert t_stats._ring_factor(kind, n) == \
                ref_stats._ring_factor(kind, n), (kind, n)
    assert t_stats.COLLECTIVE_KINDS == ref_stats.COLLECTIVE_KINDS


V5E = t_rl.Hardware(ref_mesh.PEAK_BF16_FLOPS, ref_mesh.HBM_BW,
                    ref_mesh.ICI_BW)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m",
                                  "rwkv6-3b", "seamless-m4t-large-v2"])
def test_derive_at_the_references_constants_is_its_roofline(arch):
    cfg, ref = _pair(arch)
    bytes_by_kind = {"all-reduce": 3_000_000, "all-gather": 1_250_000}
    counts = {"all-reduce": 7, "all-gather": 3}
    for i, (cell, rcell) in enumerate(zip(ALL_CELLS, REF_CELLS)):
        for tp, dp, chips in LAYOUTS:
            cost = {"flops": 1.5e13 * (i + 1), "bytes accessed": 3.25e10}
            link = 4.5e6 * (i + 1)
            got = t_rl.derive(
                cfg, cell, cost,
                t_stats.CollectiveStats([], bytes_by_kind, 4_250_000, link,
                                        counts),
                chips, tp=tp, dp=dp, kv_elem_bytes=1.25, hw=V5E)
            want = ref_rl.derive(
                ref, rcell, cost,
                ref_stats.CollectiveStats([], bytes_by_kind, 4_250_000, link,
                                          counts),
                chips, tp=tp, dp=dp, kv_elem_bytes=1.25)
            assert got.row() == want.row()
            assert got.step_time_s == want.step_time_s
            assert got.mfu == want.mfu
    h100 = t_rl.derive(cfg, ALL_CELLS[0], {"flops": 989e12},
                       t_stats.collect_stats([]), 256)
    assert h100.compute_s == 1.0 and h100.bottleneck == "compute"


def test_collect_stats_of_a_record_gives_hand_computed_totals():
    record = [("all-reduce", 1000, 16, "fwd"), ("all-gather", 1600, 16, "fwd"),
              ("all-reduce", 400, 2, "bwd"), ("all-reduce", 80, 1, "fwd"),
              ("all-gather", 64, 32, "fwd")]
    st = t_stats.collect_stats(record)
    assert st.bytes_by_kind == {"all-reduce": 1480, "all-gather": 1664}
    assert st.counts == {"all-reduce": 3, "all-gather": 2}
    assert st.total_bytes == 3144
    want = (1000 * 2 * 15 / 16 + 1600 * 15 / 16 + 400 * 2 * 1 / 2 + 0.0
            + 64 * 31 / 32)
    assert st.link_bytes == pytest.approx(want, rel=1e-15)
    assert [op.computation for op in st.ops] == [r[3] for r in record]
    assert st.summary() == ref_stats.CollectiveStats(
        [], st.bytes_by_kind, st.total_bytes, st.link_bytes,
        st.counts).summary()
    assert t_stats.collect_stats([]).summary() == "none"


def test_make_production_mesh_is_the_references_layout():
    import inspect
    src = inspect.getsource(ref_mesh.make_production_mesh)
    assert "(2, 16, 16) if multi_pod else (16, 16)" in src
    assert '("pod", "data", "model") if multi_pod' in src
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_each_config_module_is_get_config_and_the_references(arch):
    mine = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    ref = importlib.import_module(f"repro.configs.{MODULES[arch]}")
    assert mine.CONFIG == get_config(arch)
    assert mine.CONFIG.name == arch
    assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(ref.CONFIG)
