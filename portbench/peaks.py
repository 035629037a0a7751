"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense rates at the full 700 W power limit). A roofline share is
stated against these, with the card's power limit beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}
# the card the cells are sized for; the readers' bounds use its peaks
CARD = "NVIDIA H100 80GB HBM3"


def least_seconds(bytes_moved: float, fp32_flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    its memory bandwidth and the float32 operations over its peak."""
    p = PEAKS[CARD]
    return max(bytes_moved / p["hbm_bytes_per_s"], fp32_flops / p["fp32_flops"])
