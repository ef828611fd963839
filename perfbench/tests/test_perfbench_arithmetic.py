"""The yardstick's arithmetic: operation counts, rooflines, window rates and percentiles."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from perfbench import flops, peaks, stats
from perfbench.reference import resdiff as ref
from perfbench.stats import Request


def test_flop_counter_counts_a_conv_by_hand():
    b, cin, cout, h, w, k = 8, 32, 64, 128, 128, 3
    with torch.device("meta"):
        x, wt = torch.zeros(b, cin, h, w), torch.zeros(cout, cin, k, k)
        counted = flops.count(lambda: F.conv2d(x, wt, padding=1))
    assert counted == {"aten.convolution": 2.0 * b * cout * h * w * cin * k * k}


def test_flop_counter_counts_an_attention_site_by_hand():
    """The reference's blocked attention at the exact chain's first site: Q K^T and P V, 2bnmd each."""
    b, n, m, d = 8, 16384, 16384, 32
    with torch.device("meta"):
        q, k, v = torch.zeros(b, n, d), torch.zeros(b, m, d), torch.zeros(b, m, d)
        counted = flops.count(lambda: ref.attention(q, k, v, 0.1))
    assert sum(counted.values()) == 4.0 * b * n * m * d


def test_seconds_at_peak_take_each_precision():
    fl = {"aten.convolution": 989e12, "aten.bmm": 495e12}
    assert flops.seconds_at_peak([{"ops": fl, "precision": {"default": "bf16"}}]) == pytest.approx(1.0 + 495 / 989)
    assert flops.seconds_at_peak([{"ops": fl, "precision": {"default": "bf16", "aten.bmm": "tf32"}}]) == 2.0
    fp32 = flops.seconds_at_peak([{"ops": fl, "precision": {"default": "fp32"}}])
    assert fp32 == pytest.approx(3 * (989 + 495) / 495)
    two = [{"ops": {"aten.convolution": 989e12}, "precision": {"default": "bf16"}},
           {"ops": {"aten.convolution": 495e12}, "precision": {"default": "tf32"}}]
    assert flops.seconds_at_peak(two) == pytest.approx(2.0)


@pytest.mark.parametrize("shape, precision, ms", [
    ((8, 16384, 16384, 32), "bf16", 0.2779352),  # the exact chain's first site: operations bind
    ((8, 4096, 4096, 64), "bf16", 0.0347419),
    ((8, 16384, 256, 32), "bf16", 0.00524288),  # the fast profile's: bytes bind
    ((16, 4096, 4096, 40), "fp32", 0.2603010),  # SD1.5's 40-wide heads in 3xTF32
])
def test_flash_forward_bounds_match_the_kernel_table(shape, precision, ms):
    assert peaks.flash_fwd_seconds(*shape, precision) * 1e3 == pytest.approx(ms, rel=1e-5)


def test_gn_silu_bound_reads_and_writes_each_byte_once():
    shape = (8, 32, 256, 256)
    ops, n_bytes = peaks.gn_silu_work(shape, "bf16")
    assert n_bytes == 2 * 8 * 32 * 256 * 256 * 2 + 2 * 32 * 2
    assert ops == 10.0 * 8 * 32 * 256 * 256
    assert peaks.gn_silu_seconds(shape, "bf16") == pytest.approx(n_bytes / 3.35e12)


def test_window_rate_counts_whole_requests_over_the_span():
    recs = [Request(10.0 + 0.5 * i, 10.5 + 0.5 * i, 8) for i in range(10)]
    assert stats.span_s(recs) == pytest.approx(5.0)
    assert stats.items_per_s(recs) == pytest.approx(80 / 5.0)


def test_a_stall_shows_in_the_rate_and_the_tail():
    """Nine requests of 0.35 s and one that stalls for 2 s: the rate takes the stall's whole time, and the p90 sits
    between the steady requests and the stall (linear between ranks 9 and 10 of 10)."""
    t, recs = 0.0, []
    for i in range(10):
        dur = 2.0 if i == 4 else 0.35
        recs.append(Request(t, t + dur, 8))
        t += dur + 0.001
    assert stats.items_per_s(recs) == pytest.approx(80 / (9 * 0.35 + 2.0 + 9 * 0.001))
    assert stats.latency_percentile_ms(recs, 90) == pytest.approx((0.35 + 0.1 * (2.0 - 0.35)) * 1e3)
    assert stats.latency_percentile_ms(recs, 50) == pytest.approx(350.0)


def test_a_failed_request_counts_at_the_longest_time_and_carries_no_items():
    recs = [Request(0.0, 0.3, 8), Request(0.3, 0.6, 8, ok=False), Request(0.6, 1.2, 8)]
    assert stats.items_per_s(recs) == pytest.approx(16 / 1.2)
    assert stats.percentile([0.3, 0.6, 0.6], 50) == pytest.approx(0.6)
    assert stats.latency_percentile_ms(recs, 50) == pytest.approx(600.0)


def test_percentile_is_numpys_linear_rule():
    import numpy as np

    values = [float(v) for v in np.random.default_rng(0).random(113)]
    for q in (50, 90, 95, 99):
        assert stats.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))
