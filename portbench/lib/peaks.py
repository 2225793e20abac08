"""The table of peaks and the roofline bound of a kernel launch.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM3. The port's hand-written kernels compute in IEEE
float32 on the CUDA cores. A launch's bound is the larger of its bytes
(each input read once, each output written once) over the bandwidth and
its float32 operations over the rate; its roofline share is that bound
over the launch's device time.
"""

from __future__ import annotations

PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S) * 1e3


def bound_by(nbytes: float, ops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES_PER_S >= ops / PEAK_FP32_PER_S else "operations"
