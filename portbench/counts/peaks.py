"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W limit).  A share of one of them is stated
against the published peak, with the card's power limit beside it."""

#: bf16 / fp16 tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: HBM capacity, bytes
HBM_BYTES = 80e9


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the chip could take (the larger of operations over
    the bf16 peak and bytes over the HBM peak) over the time taken, in %."""
    if seconds <= 0:
        raise ValueError(f"a time of {seconds} s has no roofline share")
    return 100.0 * max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) / seconds
