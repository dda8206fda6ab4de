"""Metrics: SNR parity checks + the device peak table for roofline shares
(SURVEY.md §6).

Batched small-N FFTs and the audio chains are memory-bound, so the
speed-of-light bound is moving each sample in and out of device memory
once; ``roofline_time_s`` divides those bytes by the device's published
memory bandwidth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def snr_db(ref, test) -> float:
    """Signal-to-error ratio in dB."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    err = ref - test
    p_sig = float(np.sum(ref * ref))
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return math.inf
    if p_sig == 0.0:
        # all-zero reference with nonzero error: any leakage is infinitely
        # worse than the (silent) signal — report -inf, don't raise a
        # math-domain error out of an assertion helper
        return -math.inf
    return 10.0 * math.log10(p_sig / p_err)


@dataclass(frozen=True)
class DeviceSpec:
    """Published per-device ceilings used for roofline shares (dense
    rates, no sparsity; at the card's full power limit)."""

    name: str
    hbm_gbps: float  # device-memory bandwidth, GB/s
    f32_tflops: float  # float32 outside the tensor cores
    tf32_tflops: float
    bf16_tflops: float
    source: str


# Keyed by ``jax.Device.device_kind``.  A device missing here is an error:
# a roofline share against an assumed peak would be a made-up number.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        name="H100 SXM5 80GB", hbm_gbps=3350.0, f32_tflops=67.0,
        tf32_tflops=495.0, bf16_tflops=989.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 column"),
    "NVIDIA H100 PCIe": DeviceSpec(
        name="H100 PCIe 80GB", hbm_gbps=2000.0, f32_tflops=51.0,
        tf32_tflops=378.0, bf16_tflops=756.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, PCIe column"),
}


def device_spec(device_kind: str | None = None) -> DeviceSpec:
    """Peaks of ``device_kind`` (default: ``jax.devices()[0]``'s).
    Raises ``KeyError`` for a device the table does not hold."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def fft_roofline_bytes(batch: int, n: int, dtype_bytes: int = 4,
                       complex_io: bool = False) -> int:
    """Minimum device-memory traffic of a batched FFT: read + write each
    element once."""
    width = 2 * dtype_bytes if complex_io else dtype_bytes
    return 2 * batch * n * width


def roofline_time_s(bytes_moved: int, spec: DeviceSpec) -> float:
    return bytes_moved / (spec.hbm_gbps * 1e9)
