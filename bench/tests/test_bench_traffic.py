"""The generator: a seed gives one table; seeds give other text over the
same lengths, shuffled only within each block (so every seed runs the
same batches); the lengths follow the mix's published means."""
import math

import numpy as np
import pytest

from bench.lib import manifest, traffic

MIXES = ["filter", "map"]


def _mix(name):
    return traffic.load(manifest.ROOT / "bench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_table(name):
    m = _mix(name)
    assert traffic.table(m, 2**31 + 11) == traffic.table(m, 2**31 + 11)
    assert traffic.warm(m, 2**31 + 11) == traffic.warm(m, 2**31 + 11)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_text_same_blocks(name):
    m = _mix(name)
    a, b = traffic.table(m, 5), traffic.table(m, 2**33 + 6)
    fill = next(k for k, v in m["fields"].items() if v == "fill")
    assert [r[fill] for r in a] != [r[fill] for r in b]
    k = m["prompt_tokens"]["block"]
    for i in range(0, len(a), k):
        assert sorted(r["tokens"] for r in a[i:i + k]) == sorted(r["tokens"] for r in b[i:i + k])
    assert [r["tokens"] for r in a] != [r["tokens"] for r in b]   # another order


@pytest.mark.parametrize("name", MIXES)
def test_rows_hit_their_drawn_lengths(name):
    m = _mix(name)
    p = m["prompt_tokens"]
    rows = traffic.table(m, 77)
    want = np.sort(traffic.lengths(m, len(rows), np.random.default_rng(0)))
    assert np.array_equal(np.sort([r["tokens"] for r in rows]), want)
    assert want[0] >= p["min"] and want[-1] <= p["max"]
    assert [r["id"] for r in rows] == list(range(len(rows)))


@pytest.mark.parametrize("name", MIXES)
def test_warm_rows_span_every_length(name):
    m = _mix(name)
    p = m["prompt_tokens"]
    warm = traffic.warm(m, 3)
    lens = [r["tokens"] for r in warm]
    assert len(warm) == m["warm_rows"] and lens[0] == p["min"] and lens[-1] == p["max"]
    assert lens == sorted(lens)
    assert min(r["id"] for r in warm) >= m["table_rows"]


def test_prompt_ids_are_the_byte_tokenizer_of_the_framed_prompt():
    m = _mix("filter")
    row = traffic.table(m, 1)[0]
    text = m["frame"].replace("{langex}", f"{row['claim']} Evidence: {row['evidence']}")
    assert traffic.prompt_ids(m, row) == [traffic.BOS] + list(text.encode())
    assert len(traffic.prompt_ids(m, row)) == row["tokens"]


@pytest.mark.parametrize("name,frame,fields_mean,published", [
    ("filter", 87, 49 + 509, (8.13 + 84.76) * 6),
    ("map", 122, 64 + 1057, 64 + 176.19 * 6),
])
def test_lengths_follow_the_published_means(name, frame, fields_mean, published):
    """The log-normal's mean, median * exp(sigma^2 / 2), is the frame plus
    the fields' published means at 6 bytes a word; clipping at the
    engine's cut brings the drawn mean below it."""
    m = _mix(name)
    p = m["prompt_tokens"]
    empty = {k: "" for k in m["fields"]}
    assert len(traffic.encode(traffic.frame(m, empty))) == frame
    assert fields_mean == pytest.approx(published, abs=1)
    assert p["median"] * math.exp(p["sigma"] ** 2 / 2) == pytest.approx(frame + fields_mean,
                                                                         rel=2e-3)
    lens = np.array([r["tokens"] for r in traffic.table(m, 9)])
    assert 0.9 * (frame + fields_mean) < lens.mean() < frame + fields_mean


def test_filter_batches_pad_to_their_longest_real_row():
    """Each 32-row batch pads to its longest row: with these draws every
    batch reaches the engine's 1024, about 41% of the computed tokens
    padding (a batch of the quantiles would pad as much: its longest row
    is 1024 too)."""
    m = _mix("filter")
    lens = np.array([r["tokens"] for r in traffic.table(m, 9)]).reshape(-1, 32)
    widths = lens.max(axis=1)
    assert (widths == 1024).all()
    assert 0.38 < 1 - lens.sum() / (widths * 32).sum() < 0.44
