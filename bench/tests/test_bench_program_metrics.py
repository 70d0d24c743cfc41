"""The readers of the program's spans (``lib/program.py``) over made-up
records: hand-built engine spans and device records, each value worked out
by hand, and nothing (None, never 0) without the program's tracer or
without a span of the reader's name."""
import numpy as np
import pytest

from bench.lib.cell import Record, reader
from bench.lib.program import device_spans, of, starts_inside
from bench.tests.test_bench_metrics import _trace
from repro_torch.obs.trace import Span

MAP = ["map.decode_enqueue_ms", "map.decode_wait_ms", "map.launches_per_decode_step",
       "map.sched_ms_per_step", "map.prefill_pad_share", "map.idle_in_enqueue",
       "map.step_itl_p95_ms"]
MS = 1_000_000


class _Tracer:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return sorted(self._spans, key=lambda s: s.t0)


def _span(i, parent, name, a_ms, b_ms, **attrs):
    s = Span(i, parent, name, "span", attrs)
    s.t0, s.t1 = a_ms / 1e3, b_ms / 1e3           # wall ns = t * 1e9 (anchor 0)
    return s


def _step(i, phase, a, b, ra, rb, cut, rids, **attrs):
    """A scheduler step [a, b] with its runner span [ra, rb], split into
    enqueue [ra, cut] and to_host [cut, rb] (ms)."""
    return [_span(i, None, "scheduler/step", a, b, phase=phase, rids=rids),
            _span(i + 1, i, f"runner/{phase}", ra, rb, **attrs),
            _span(i + 2, i + 1, "runner/enqueue", ra, cut),
            _span(i + 3, i + 1, "runner/to_host", cut, rb)]


MAP_SPANS = (_step(1, "prefill", 0, 100, 10, 90, 60, [0], tokens=100, bucket=128)
             + _step(5, "decode", 100, 200, 105, 195, 175, [0])
             + _step(9, "prefill", 200, 300, 202, 298, 250, [1], tokens=200, bucket=256)
             + _step(13, "decode", 300, 400, 310, 390, 350, [0, 1])
             # the next call's first request, whose id 0 is used again
             + _step(17, "prefill", 400, 700, 410, 690, 600, [0], tokens=60, bucket=64)
             + _step(21, "decode", 700, 760, 705, 755, 740, [0])
             # after the window: left out
             + _step(25, "decode", 1200, 1300, 1210, 1290, 1250, [0]))

# Each step's kernels ("k") and its copy to the host, which ends 1 ms before
# the step's to_host span.  On the profiler's clock the fourth step's
# records read 6 ms late (kernel [320, 330] and copy [385, 389] on the
# program's), its copy 5 ms after the host had it, and the sixth step's 18
# ms early, 3 ms before the host started the step: each moves by that least.
# The fifth step's clock steps within it: its kernel starts 8 ms before the
# host started the step and its copy ends 2 ms after the host had it, so
# the kernel moves 8 ms on and the copy, 0.9 of the way, 1 ms back.
DTOH = "Memcpy DtoH (Device -> Pageable)"
RECORDS = [("k", 20, 50), (DTOH, 80, 89),
           ("k", 120, 130), ("k", 150, 160), (DTOH, 180, 194),
           (DTOH, 290, 297),
           ("k", 326, 336), (DTOH, 391, 395),
           ("k", 402, 452), (DTOH, 663, 692),
           ("k", 702, 712), (DTOH, 727, 736),
           ("k", 1220, 1230), (DTOH, 1280, 1289)]
DEVICE = _trace([n for n, _, _ in RECORDS], [[a * MS, b * MS] for _, a, b in RECORDS])


def _record(spans=MAP_SPANS, trace=DEVICE, **kw):
    if spans is not None:
        kw["program"] = _Tracer(spans)
    return Record(trace=trace, window_s=1.0, wall=(0, 1000 * MS), **kw)


def test_map_readers_by_hand():
    rec = _record()
    assert reader("map.decode_enqueue_ms")(rec) == pytest.approx((70 + 40 + 35) / 3)
    assert reader("map.decode_wait_ms")(rec) == pytest.approx((20 + 40 + 15) / 3)
    # decode steps of 100, 100, 60 ms around runners of 90, 80, 50; prefills left out
    assert reader("map.sched_ms_per_step")(rec) == pytest.approx((10 + 20 + 10) / 3)
    assert reader("map.prefill_pad_share")(rec) == pytest.approx((1 - 360 / 448) * 100)
    # request 0: 100 -> 200 -> 400, then anew 700 -> 760; request 1: 300 -> 400
    assert reader("map.step_itl_p95_ms")(rec) == pytest.approx(200)
    # records starting at 120, 150, 180; 321, 386 and 705, 730 (once moved)
    assert reader("map.launches_per_decode_step")(rec) == pytest.approx(7 / 3)
    # enqueue [10,60] [105,175] [202,250] [310,350] [410,600] [705,740] less
    # the records (moved): 20 + 50 + 48 + 30 + 140 + 16 = 304 ms of the 1000
    assert reader("map.idle_in_enqueue")(rec) == pytest.approx(30.4)
    idle = (1 - (30 + 9 + 10 + 10 + 14 + 7 + 10 + 4 + 50 + 29 + 10 + 9) / 1000) * 100
    assert reader("map.idle_in_enqueue")(rec) <= reader("map.idle_share")(rec) == \
        pytest.approx(idle)


def test_device_records_move_onto_the_programs_clock_by_step():
    moved = device_spans(_record())
    shift = (moved - DEVICE.spans) // MS
    assert shift[:, 0].tolist() == [0] * 6 + [-5, -5, 8, -1] + [3] * 4      # after: the last's
    assert (shift[:, 0] == shift[:, 1]).all()
    # nothing to anchor on: no copy to the host, or no to_host span
    plain = _trace(["k"] * len(RECORDS), DEVICE.spans)
    assert (device_spans(_record(trace=plain)) == DEVICE.spans).all()
    assert (device_spans(_record(spans=[])) == DEVICE.spans).all()
    assert device_spans(_record(trace=None)) is None
    assert device_spans(_record(trace=_trace([], []))) is None


def test_filter_pad_share_by_hand():
    spans = [_span(1, None, "engine/score", 0, 100, rows=32, width=1024, tokens=20000),
             _span(2, None, "engine/score", 100, 200, rows=16, width=512, tokens=5000)]
    assert reader("filter.pad_share")(_record(spans)) == pytest.approx(
        (1 - 25000 / (32 * 1024 + 16 * 512)) * 100)


@pytest.mark.parametrize("name", MAP + ["filter.pad_share"])
def test_nothing_to_read_is_none(name):
    assert reader(name)(_record(spans=None)) is None                 # no program tracer
    assert reader(name)(_record(spans=[])) is None                   # no span at all
    other = [_span(1, None, "dispatch/batch", 0, 10)]
    assert reader(name)(_record(spans=other)) is None                # none of its name


@pytest.mark.parametrize("name", ["map.sched_ms_per_step", "map.step_itl_p95_ms"])
def test_decode_readers_without_a_decode_step_are_none(name):
    assert reader(name)(_record(spans=MAP_SPANS[:4])) is None        # one prefill alone


@pytest.mark.parametrize("name", ["map.launches_per_decode_step", "map.idle_in_enqueue"])
def test_device_readers_need_records(name):
    assert reader(name)(_record(trace=None)) is None
    assert reader(name)(_record(trace=_trace([], []))) is None


def test_spans_under_a_parent_and_self_time():
    rec = _record()
    enq = of(rec, "runner/enqueue", parent="runner/prefill")
    assert enq.wall.tolist() == [[10 * MS, 60 * MS], [202 * MS, 250 * MS], [410 * MS, 600 * MS]]
    steps = of(rec, "scheduler/step")
    assert (steps.self_ns // MS).tolist() == [20, 10, 4, 20, 20, 10]
    assert of(rec, "runner/decode", parent="runner/prefill") is None


def test_starts_inside():
    spans = np.array([[30, 40], [0, 10]])
    assert starts_inside(np.array([-1, 0, 5, 10, 20, 30, 39, 40, 99]), spans) == 4
