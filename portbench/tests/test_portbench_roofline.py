import pytest

from portbench import roofline


def test_product_block_least_time_is_its_bytes():
    nbytes, flop = roofline.decimator_work(10_240_000, 4, 6)
    assert nbytes == 10_240_000 * 4 + 160_000 * 8  # 42.24 MB
    assert flop == 160_000 * 2 * 3907 * 2
    assert roofline.decimator_least_ms(10_240_000, 6) == pytest.approx(0.012609, rel=1e-4)


def test_gear_block_least_time_is_its_bytes():
    assert roofline.decimator_least_ms(1 << 25, 6) == pytest.approx(
        ((1 << 25) * 4 + (1 << 19) * 8) / 3.35e12 * 1e3)
    assert roofline.decimator_least_ms(1 << 25, 6) == pytest.approx(0.041316, rel=1e-4)


def test_operations_bound_when_they_outweigh_the_bytes():
    ms = roofline.least_ms(1.0, 989e12)
    assert ms == pytest.approx(1e3)
