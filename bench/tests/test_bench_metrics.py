"""Each per-layer metric's reader over a made-up record: the value worked
out by hand, and nothing (None, never 0) where there is nothing to read."""
import numpy as np
import pytest

from bench.costs import transformer as cm
from bench.lib.cell import Record, reader
from bench.lib.manifest import load
from bench.lib.trace import DeviceTrace, Spans, gaps_ns, idle_gaps, union_ns
from bench.tests.test_bench_costs import DENSE

NAME = "NVIDIA H100 80GB HBM3"


class _Adapter:
    def batches(self):
        return [[3, 5], [4]]

    def requests(self):
        return [{"prompt": 3, "times": [1.0, 1.1, 1.2], "contexts": [3, 4], "failed": False}]

    def decode_rows(self):
        return [[3], [4]]


def _trace(names, spans):
    t = DeviceTrace.__new__(DeviceTrace)
    t.names, t.spans, t.read_s = names, np.array(spans, np.int64).reshape(-1, 2), 0.0
    return t


def _record(trace=None):
    s = Spans()
    s.add("sem_filter_gold", 0.0, 1.0, 0)
    s.add("logprobs", 0.1, 0.4, 100_000_000)
    s.add("logprobs", 0.5, 0.9, 500_000_000)
    s.add("prefill", 0.0, 0.25, 0, slot=0)
    s.add("decode", 0.3, 0.35, 300_000_000)
    s.add("decode", 0.4, 0.5, 400_000_000)
    return Record(arch=DENSE, costs=cm, adapter=_Adapter(), spans=s, trace=trace, window_s=1.0,
                  wall=(0, 1_000_000_000), device_name=NAME)


TRACE = _trace(["flash_attention_wgmma_bf16", "Memcpy DtoH (Device -> Pageable)",
                "decode_attention_mma_bf16", "ampere_gemm"],
               [[0, 100_000], [200_000_000, 300_000_000], [400_000_000, 400_001_000],
                [250_000_000, 350_000_000]])


def test_every_per_layer_metric_has_a_reader():
    for m in load()["per_layer"]:
        assert callable(reader(m["name"]))


def test_host_and_span_metrics():
    rec = _record()
    assert reader("filter.host_ms_per_batch")(rec) == pytest.approx((1.0 - 0.7) / 2 * 1e3)
    assert reader("map.prefill_share")(rec) == pytest.approx(25.0)
    assert reader("map.decode_step_ms")(rec) == pytest.approx(75.0)


def test_device_metrics():
    rec = _record(TRACE)
    assert reader("filter.d2h_ms_per_batch")(rec) == pytest.approx(100.0 / 2)
    assert reader("filter.idle_share")(rec) == pytest.approx(100 * (1 - 0.150101))
    from bench import peaks
    pk = peaks.for_device(NAME)
    bound = 0.0
    for batch in ([3, 5], [4]):
        f = sum(cm.flash_attention_bound(DENSE, t)[0] for t in batch)
        b = sum(cm.flash_attention_bound(DENSE, t)[1] for t in batch)
        bound += max(f / pk.bf16, b / pk.hbm)
    assert reader("filter.flash_attention_roofline")(rec) == pytest.approx(
        bound * DENSE.layers / 1e-4 * 100)
    dec = sum(max(cm.decode_attention_bound(DENSE, c)[0] / pk.bf16,
                  cm.decode_attention_bound(DENSE, c)[1] / pk.hbm) for c in (3, 4))
    assert reader("map.decode_attention_roofline")(rec) == pytest.approx(
        dec * DENSE.layers / 1e-6 * 100)
    flops = sum(cm.prompt_flops(DENSE, t) for t in (3, 5, 4))
    assert reader("filter.mfu")(rec) == pytest.approx(flops / pk.bf16 * 100)
    flops = cm.prompt_flops(DENSE, 3) + cm.decode_token_flops(DENSE, 3) + \
        cm.decode_token_flops(DENSE, 4)
    assert reader("map.mfu")(rec) == pytest.approx(flops / pk.bf16 * 100)


@pytest.mark.parametrize("name", ["filter.d2h_ms_per_batch", "filter.flash_attention_roofline",
                                  "map.decode_attention_roofline", "filter.idle_share",
                                  "map.idle_share"])
def test_nothing_to_read_is_none(name):
    assert reader(name)(_record()) is None
    assert reader(name)(_record(_trace([], []))) is None


def test_union_and_gaps():
    s = np.array([[0, 10], [5, 20], [30, 40]])
    assert union_ns(s) == 30
    assert gaps_ns(s, 0, 50).tolist() == [[20, 30], [40, 50]]
    t = _trace(["k"] * 3, s.tolist())
    sp = Spans()
    sp.add("decode", 0.0, 1.0, 15)
    sp.add("host", 0.0, 1.0, 35)
    assert [g[0].split(" ")[0] for g in idle_gaps(t, sp, 0, 50)] == ["decode", "host"]
