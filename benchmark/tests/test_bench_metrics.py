"""The per-layer readers on made-up facts and traces: each returns nothing
where there is nothing to read, and a roofline reads 100 % when the kernels
took exactly the bound."""

from pathlib import Path

import pytest

from benchmark.harness import costs, spec
from benchmark.harness.trace import DeviceTrace, Kernel

BENCH = Path(__file__).resolve().parents[1]
XL = {"d_model": 2048, "d_ff": 5120, "num_heads": 32, "d_kv": 64,
      "num_decoder_layers": 24, "tts": {"audio_vocab_size": 65536}}


def reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (BENCH / "metrics").glob("*.py")))
def test_reader_returns_none_without_data(name):
    assert reader(name).read({}, None) is None


def test_idle_share_is_the_union():
    tr = DeviceTrace(kernels=[Kernel("a", 0.0, 2.0), Kernel("b", 1.0, 3.0),
                              Kernel("c", 5.0, 6.0)], window_s=10.0,
                     start_s=0.0, end_s=10.0)
    assert reader("idle_share.offline").read({}, tr) == pytest.approx(60.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] in ("a", "b")
    assert bd["idle_gaps"][0][1] == pytest.approx(4.0)


def test_k2_roofline_is_100_at_the_bound():
    facts = {"config": dict(XL, num_heads=32),
             "traced_batch": {"rows": [(1, 3, 10), (1, 2, 20)], "steps": 3,
                              "kv_elem": 1, "kv_scales": True,
                              "w_bytes": 1.0}}
    mod = reader("k2_roofline.offline")
    w = costs.widths_of(XL)
    bound = sum(mod.step_bound_s(w, 24, 65541,
                                 [(p, s, e) for p, g, e in
                                  facts["traced_batch"]["rows"] if s < g],
                                 1, True, 1.0) for s in range(3))
    name = "void (anonymous namespace)::slab_split_kernel<true>(x)"
    tr = DeviceTrace(kernels=[Kernel(name, 0.0, bound / 2),
                              Kernel("void t5g::w8a8_gemv_kernel<16, float, "
                                     "false>(t5g::GemvArgs)", 1.0,
                                     1.0 + bound / 2),
                              Kernel("other", 0.0, 5.0)], window_s=9.0)
    assert mod.read(facts, tr) == pytest.approx(100.0)


def test_k1_roofline_is_100_at_the_bound():
    seg = {"bodies": 2, "rows": [(1, 5, 2, 40), (1, 0, 1, 30)]}
    facts = {"config": XL, "traced_segments": [seg], "kv_elem": 2,
             "kv_scales": False}
    w = costs.widths_of(XL)
    bound = 0.0
    for b, rows in ((0, [(1, 5, 40), (1, 0, 30)]), (1, [(1, 6, 40)])):
        sb, so = costs.attention_bytes_ops(w, [(p, g) for p, g, _ in rows],
                                           2, False, True)
        cb, co = costs.attention_bytes_ops(w, [(x,) for _, _, x in rows],
                                           2, False, False)
        bound += 24 * (costs.bound_s(sb, so, costs.PEAK_F32_FLOPS)
                       + costs.bound_s(cb, co, costs.PEAK_F32_FLOPS))
    tr = DeviceTrace(kernels=[Kernel("void t5g_split::split_kernel<1>(p)",
                                     0.0, bound)], window_s=1.0)
    assert reader("k1_roofline.arrivals").read(facts, tr) == pytest.approx(
        100.0)


def test_step_and_admission_means():
    segs = [{"start": 0.0, "end": 0.5, "bodies": 50, "rows": []},
            {"start": 1.0, "end": 1.3, "bodies": 50, "rows": []}]
    assert reader("step_ms.arrivals").read({"segments": segs}, None) == \
        pytest.approx(8.0)
    assert reader("admit_ms.arrivals").read(
        {"admit_walls_s": [0.1, 0.2]}, None) == pytest.approx(150.0)


def test_offline_shares():
    facts = {"batch_sizes": [16, 16, 8], "precision": "int8",
             "traced_batch": {"wall_s": 50.0, "vocode_s": 5.0,
                              "model_flops": 1979e12 * 0.5}}
    assert reader("batch_rows.offline").read(facts, None) == \
        pytest.approx(40 / 3)
    assert reader("vocode_share.offline").read(facts, None) == \
        pytest.approx(10.0)
    assert reader("mfu.offline").read(facts, None) == pytest.approx(1.0)
