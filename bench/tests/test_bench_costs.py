"""The cost arithmetic against hand-worked values at smoke shapes, and
percentiles over every sample."""
import pytest

from bench import peaks
from bench.costs import transformer as cm
from bench.reference.transformer import Arch
from bench.lib.stats import percentile

DENSE = Arch(name="t", layers=2, d=8, heads=2, kv_heads=1, d_ff=16, vocab=10,
             norm_eps=1e-5, rope_theta=1e4)
MOE = Arch(name="m", layers=1, d=8, heads=2, kv_heads=2, d_ff=4, vocab=10, norm_eps=1e-5,
           rope_theta=1e4, experts=4, top_k=2, capacity_factor=1.25)


def test_pairs():
    assert cm.pairs(4, 4) == 10 == cm.causal_pairs(4)
    assert cm.pairs(5, 5, window=2) == 9 == cm.causal_pairs(5, 2)
    assert cm.pairs(1, 8, offset=7) == 8
    assert cm.pairs(3, 3, causal=False) == 9


def test_dense_flops_by_hand():
    # hd 4; q 8x(2*4), k and v 8x4 each, o 8x8: 2*(32+16+64+... ) per token
    proj = 2 * (8 * 8 + 8 * 4 + 8 * 4) + 2 * 8 * 8          # 384
    ffn = 2 * 3 * 8 * 16                                     # 768
    assert cm.layer_matmul_flops_per_token(DENSE) == proj + ffn
    t = 3
    attn = 4 * 2 * 4 * 6                                     # 6 causal pairs
    assert cm.prompt_flops(DENSE, t) == 2 * (t * (proj + ffn) + attn) + 2 * 8 * 10
    assert cm.decode_token_flops(DENSE, 5) == 2 * (proj + ffn + 4 * 2 * 4 * 6) + 160


def test_moe_counts_top_k_experts_and_router():
    proj = 2 * (8 * 8 * 3) + 2 * 8 * 8
    assert cm.layer_matmul_flops_per_token(MOE) == proj + 2 * 8 * 4 + 2 * 6 * 8 * 4


def test_attention_bounds_by_hand():
    f, b = cm.flash_attention_bound(DENSE, 3)
    assert f == 4 * 2 * 4 * 6
    assert b == 2 * 2 * (3 * 2 * 4 + 3 * 1 * 4)
    f, b = cm.decode_attention_bound(DENSE, 5)                 # 6 rows attended
    assert f == 4 * 6 * 2 * 4
    assert b == 6 * 1 * 4 * 2 * 2 + 2 * 2 * 4 * 2 + 4


def test_peaks():
    assert peaks.for_device("NVIDIA H100 80GB HBM3").bf16 == 989e12
    assert peaks.for_device("NVIDIA H100 PCIe").hbm == 2.0e12
    with pytest.raises(ValueError):
        peaks.for_device("cpu")


def test_percentile_takes_every_sample():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile([5.0] * 94 + [100.0] * 6, 95) == 100.0   # a tail of 6% is seen
    assert percentile([3.0], 95) == 3.0

