"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): the rooflines' denominators."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, ops: float) -> float:
    """The least time the card could take to move n_bytes and do ops f32
    operations: the larger of the two bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
