import numpy as np
import pytest
import torch

from portbench import capture

SPEC = {"count": 2, "min_spacing_hz": 16000, "levels_dbfs": [-12.0, -42.0],
        "tone_hz": [300, 3000], "deviation_hz": [2500, 5000]}
TRAFFIC = {"carriers": SPEC, "noise_dbfs": -22, "ring_blocks": 2}
FREQS = [-12000.0, -4000.0, 4000.0, 12000.0]
SEED = 2**31 + 977  # the driver's seeds pass 32 signed bits


def test_ring_is_the_same_for_the_same_seed():
    a = capture.ring(TRAFFIC, FREQS, 625000, 4096, SEED, "cpu")
    b = capture.ring(TRAFFIC, FREQS, 625000, 4096, SEED, "cpu")
    assert a.dtype == torch.int16 and a.shape == (2, 4096, 2)
    assert torch.equal(a, b)
    assert not torch.equal(a, capture.ring(TRAFFIC, FREQS, 625000, 4096, SEED + 1, "cpu"))


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_carriers_keep_the_spacing_and_the_set_of_levels(seed):
    cs = capture.draw_carriers(SPEC, FREQS, seed)
    f = sorted(c.freq_hz for c in cs)
    assert f[1] - f[0] >= 16000 and set(f) <= set(FREQS)
    assert sorted(c.level_dbfs for c in cs) == [-42.0, -12.0]
    assert all(300 <= c.tone_hz <= 3000 and 2500 <= c.deviation_hz <= 5000 for c in cs)


def test_no_choice_raises():
    with pytest.raises(ValueError):
        capture.draw_carriers(dict(SPEC, count=4), FREQS, 1)


def test_carrier_lands_at_its_frequency():
    spec = dict(SPEC, count=1, levels_dbfs=[-6.0], deviation_hz=[1.0, 1.0])
    traffic = {"carriers": spec, "noise_dbfs": -90, "ring_blocks": 1}
    x = capture.ring(traffic, [12000.0], 640000, 64000, 3, "cpu")[0].double().numpy()
    spec_mag = np.abs(np.fft.fft(x[:, 0] + 1j * x[:, 1]))
    assert np.fft.fftfreq(64000, 1 / 640000)[np.argmax(spec_mag)] == pytest.approx(12000, abs=20)


def test_many_channels_draw_one_carrier_a_slot():
    freqs = [48000.0 * c + 125.0 * c for c in range(-32, 32)]
    spec = dict(SPEC, count=16, min_spacing_hz=40000, levels_dbfs=[-15.0 - 2 * i for i in range(16)])
    cs = capture.draw_carriers(spec, freqs, SEED)
    f = sorted(c.freq_hz for c in cs)
    assert len(set(f)) == 16 and set(f) <= set(freqs)
    assert sorted(c.level_dbfs for c in cs) == sorted(spec["levels_dbfs"])
    assert f != sorted(c.freq_hz for c in capture.draw_carriers(spec, freqs, SEED + 1))
