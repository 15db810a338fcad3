"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity),
at its 700 W limit. A share of a peak is stated beside the card's power
limit, which the result line carries."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline's least time: the larger of compute and memory time."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)
