"""The benchmark's peak-rate table: keyed by device kind, H100 present,
an unknown device an error (never a default)."""

import jax
import pytest

from benchmarks import suite


def test_h100_published_peaks():
    p = suite.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12
    assert p["tf32_flops"] == 495e12
    assert p["int8_ops"] == 1979e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["power_limit_w"] == 700


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        suite.peaks("Some Other Accelerator")


def test_roofline_on_a_device_without_peaks_raises():
    assert jax.devices()[0].device_kind not in suite.PEAKS
    with pytest.raises(KeyError):
        suite.roofline(1e-3, flops=1e9)
