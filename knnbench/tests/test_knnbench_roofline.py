"""The byte counts behind grid_round_roofline."""

from knnbench import roofline


def test_round_bytes_counts_each_byte_once():
    # 2^17 query rows in 3-D against 2^20 points, k = 8
    q, n, d, k = 1 << 17, 1 << 20, 3, 8
    want = q * d * 4 + n * d * 4 + q * k * 8
    assert roofline.round_bytes(q, n, d, k) == want == 22_544_384


def test_rounds_bytes_leaves_out_the_brute_tail():
    rounds = [(100, 0.5), (10, 1.0), (3, float("inf"))]
    got = roofline.rounds_bytes(rounds, 1000, 2, 4)
    assert got == (roofline.round_bytes(100, 1000, 2, 4)
                   + roofline.round_bytes(10, 1000, 2, 4))
    assert roofline.rounds_bytes([], 1000, 2, 4) == 0


def test_peaks_are_the_published_h100_sxm_rates():
    assert roofline.H100["hbm_bytes_per_s"] == 3.35e12
    assert roofline.H100["fp32_flops_per_s"] == 67e12
    assert roofline.H100["bf16_flops_per_s"] == 989e12
