"""The yardstick's arithmetic against hand counts at small shapes."""
import pytest
import torch

from port_bench import roofline, trace


def test_forward_bound_by_hand():
    sfu = 1e30  # no exp2 limit
    b, t, h, d = 2, 8, 4, 16
    nbytes = 2 * (b * t * 3 * h * d) + 2 * (b * t * h * d) + 2 * h * t * t
    assert roofline.attention_fwd_bound_s((b, t, h, d), sfu) == pytest.approx(
        max(nbytes / 3.35e12, 4 * b * h * t * t * d / 989e12))
    stats = nbytes + 2 * h * t * t + 4 * b * h * t
    assert roofline.attention_fwd_bound_s((b, t, h, d), sfu, bias_bytes=4, stats=True) == \
        pytest.approx(stats / 3.35e12)


def test_exp2_bound_and_backward():
    sfu = roofline.sfu_per_s(132, 1980.0)
    assert sfu == 132 * 16 * 1980e6
    call = (32, 1600, 16, 48)
    exps = 32 * 16 * 1600 ** 2
    assert roofline.attention_fwd_bound_s(call, sfu) == pytest.approx(exps / sfu)
    b, t, h, d = 8, 496, 16, 48
    nbytes = 2 * (2 * b * t * 3 * h * d + 2 * b * t * h * d) + 4 * (2 * h * t * t + b * h * t)
    want = max(nbytes / 3.35e12, 10 * b * h * t * t * d / 989e12, b * h * t * t / sfu)
    assert roofline.attention_bwd_bound_s((b, t, h, d), sfu) == pytest.approx(want)


def test_flops_counted_on_meta():
    lin = torch.nn.Linear(64, 32, device="meta")
    x = torch.zeros((5, 64), device="meta", requires_grad=True)
    assert roofline.count_flops(lambda: lin(x)) == 2 * 5 * 64 * 32
    assert roofline.count_flops(lambda: lin(x).sum().backward()) == 3 * 2 * 5 * 64 * 32


def test_attention_calls_are_the_model_shapes():
    from port_bench.reference.diff_blocks import AttentionBlock

    blk = AttentionBlock(64, 4)
    calls = roofline.attention_calls(blk, AttentionBlock, lambda: blk(torch.zeros(3, 10, 64)))
    assert calls == [(3, 10, 4, 16)]


def test_union_and_gaps():
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
