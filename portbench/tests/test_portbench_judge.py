"""The reference against the port's CPU path at tiny sizes, through the
whole harness; its control and planted faults must come out not correct."""

import copy

import numpy as np
import pytest
import torch

from portbench import control, harness, judge

from . import tiny

CELLS = tiny.CELLS
SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, patch=None, seconds=0.5):
    return harness.run_cell(tiny.cell(name), SEED, seconds, False, "cpu", patch=patch)


@pytest.mark.parametrize("name", CELLS)
def test_port_on_the_cpu_agrees_with_the_reference(name):
    out = _run(name)
    assert out.correct, out.check
    assert out.attempted >= 3 and out.failed == 0
    assert set(out.check) == set(tiny.cell(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = _run(name, control.in_place_of_program)
    assert not out.correct, out.check


def _loudest(rows) -> int:
    return int(torch.stack([r.float().pow(2).mean() for r in rows]).argmax())


def _product_fault(kind):
    def patch(system):
        pipe = system.pipe
        step_packed, step = pipe.step_packed, pipe.step
        if kind == "state unchanged":
            pipe.step_packed = lambda state, raw, dyn=None: (state, step_packed(state, raw, dyn)[1])
            return

        def broken(state, raw, dyn=None):
            if kind == "squelch ignored":
                dyn = [dict(d, squelch_db=-300.0) for d in (dyn or pipe.default_dyn())]
            state, outs = step(state, raw, dyn)
            chans = outs["channels"]
            if kind == "half the channels left out":
                for c in chans[len(chans) // 2:]:
                    c["audio"] = torch.zeros_like(c["audio"])
            elif kind == "an answer altered":
                c = chans[_loudest([c["audio"] for c in chans])]
                c["audio"] = c["audio"] * 1.01
            return state, outs

        pipe.step = broken
    return patch


def _bank_fault(kind):
    def patch(system):
        if kind == "squelch ignored":
            config = copy.deepcopy(system.config)
            config["bank"]["settings"]["squelch_db"] = -300.0
            deaf = system.driver.System(config, system.traffic, system.ring, system.device)
            system.step, system.init = deaf.step, deaf.init
            return
        step = system.step

        def broken(state, x, carry, res, idx):
            new_state, audio, new_carry = step(state, x, carry, res, idx)
            if kind == "state unchanged":
                return state, audio, carry
            audio = audio.clone()
            if kind == "half the channels left out":
                audio[audio.shape[0] // 2:] = 0
            else:
                audio[_loudest(audio)] *= 1.01
            return new_state, audio, new_carry

        system.step = broken
    return patch


FAULTS = ["state unchanged", "half the channels left out", "an answer altered",
          "squelch ignored"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    # one card: there is no exchange between chips to leave out
    bank = tiny.cell(name).config["driver"] == "bankgear"
    out = _run(name, (_bank_fault if bank else _product_fault)(fault))
    assert not out.correct, out.check


def test_click_moves_the_off_share_by_its_span_only():
    rng = np.random.default_rng(0)
    want = rng.standard_normal(49152)
    got = want.copy()
    got[1000:1301] += 1.0  # one discriminator wrap, spread by the 301-tap bandpass
    assert judge.off_share(got, want) == pytest.approx(301 / 49152)
    assert judge.off_share(want * 1.01, want) > 0.9
    assert judge.rel_err(got, want) > 0.05


def test_verdict_fails_nan_and_missing_numbers():
    ok, check = judge.verdict({"a": 1e-6}, {"a": 1e-5})
    assert ok and check["a"] == {"value": 1e-6, "limit": 1e-5}
    assert not judge.verdict({"a": float("nan")}, {"a": 1e-5})[0]
    assert not judge.verdict({}, {"a": 1e-5})[0]
