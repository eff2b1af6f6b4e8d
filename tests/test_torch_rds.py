"""The port's RDS and RDS-TMC host copies (`channels/rds.py`,
`channels/rdstmc.py`, `channels/rdstmc_events.py`) against the JAX
package's, and RDS through the port's broadcast-FM receiver against RDS
through JAX's.

- The code: each copy's module body equals the JAX module's, docstrings
  aside; the port's rds uses the port's rdstmc.
- The decoders: every JAX test of tests/test_bfm.py (the RDS cases) and
  tests/test_rdstmc.py is run with JAX's RDSDecoder recording what it is
  fed (bits, basebands, groups); the same feed through the port's decoder
  gives the same returns and the same status, field for field. The TMC
  helpers agree on every event code of the table.
- The chain: a 384 kS/s stereo MPX with a 57 kHz RDS subcarrier carrying
  0A (PI, PS), 2A (RadioText), 4A (clock-time) and 8A (a TMC event),
  streamed block by block through JAX's BFM under jit and the port's on
  the CPU (rds_active): each block's RDS baseband ≥ 80 dB from JAX's,
  and the groups each decoder recovers, and its status, equal.
"""

from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_bfm
import test_rdstmc
from sdrangel_tpu.channels import demod_bfm as jbfm
from sdrangel_tpu.channels import rds as jrds
from sdrangel_tpu.channels import rdstmc as jrdstmc
from sdrangel_tpu.channels import rdstmc_events as jevents
from sdrangel_tpu_torch.channels import demod_bfm as pbfm
from sdrangel_tpu_torch.channels import rds as prds
from sdrangel_tpu_torch.channels import rdstmc as prdstmc
from sdrangel_tpu_torch.channels import rdstmc_events as pevents
from torch_port_util import CPU, agreement_db, code_without_docstrings

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", ["rds.py", "rdstmc.py", "rdstmc_events.py"])
def test_copy_code_equals_jax(module):
    assert (code_without_docstrings(REPO / "sdrangel_tpu_torch" / "channels" / module)
            == code_without_docstrings(REPO / "sdrangel_tpu" / "channels" / module))
    assert prds.rdstmc is prdstmc and prdstmc.EVENTS is pevents.EVENTS
    assert pevents.EVENTS == jevents.EVENTS


class _Recording(jrds.RDSDecoder):
    """JAX's decoder, logging every call the test makes and its return
    (the calls it makes on itself are not logged)."""

    made: list = []

    def __init__(self, *a, **k):
        self._depth = 0
        super().__init__(*a, **k)
        self.log = [("__init__", a, k, None)]
        _Recording.made.append(self)

    def _call(self, name, *args):
        self._depth += 1
        try:
            out = getattr(super(), name)(*args)
        finally:
            self._depth -= 1
        if self._depth == 0:
            self.log.append((name, tuple(np.array(a) if isinstance(a, np.ndarray) else
                                         list(a) if isinstance(a, list) else a for a in args),
                             out))
        return out

    def feed_baseband(self, bb):
        return self._call("feed_baseband", bb)

    def _feed_bit(self, bit):
        return self._call("_feed_bit", bit)

    def parse_group(self, g):
        return self._call("parse_group", g)


def _replay(log):
    """The recorded calls on the port's decoder: its returns and status."""
    (_, a, k, _), calls = log[0], log[1:]
    dec = prds.RDSDecoder(*a, **k)
    return [getattr(dec, name)(*args) for name, args, _ in calls], dec.status


_JAX_RDS_TESTS = [
    (test_bfm, "test_rds_codec_roundtrip"), (test_bfm, "test_rds_clock_time_group"),
    (test_bfm, "test_rds_single_bit_correction"), (test_bfm, "test_rds_burst_correction"),
    (test_bfm, "test_rds_af_list"), (test_bfm, "test_rds_flags_pin_ptyn_oda_eon_tmc"),
    (test_bfm, "test_rds_radiotext_plus"),
    *((test_rdstmc, name) for name in dir(test_rdstmc)
      if name.startswith("test_") and callable(getattr(test_rdstmc, name))),
]


@pytest.mark.parametrize("module,name", _JAX_RDS_TESTS,
                         ids=[f"{m.__name__}.{n}" for m, n in _JAX_RDS_TESTS])
def test_decoder_equals_jax_on_jax_test_inputs(monkeypatch, module, name):
    monkeypatch.setattr(_Recording, "made", [])
    monkeypatch.setattr(module.rds, "RDSDecoder", _Recording)
    getattr(module, name)()  # JAX's own assertions hold
    for jdec in _Recording.made:
        outs, status = _replay(jdec.log)
        assert outs == [out for *_, out in jdec.log[1:]]
        assert dataclasses.asdict(status) == dataclasses.asdict(jdec.status)
        assert status.pty_name == jdec.status.pty_name


def test_tmc_helpers_equal_jax_over_the_table():
    for code, (_, qt) in jevents.EVENTS.items():
        assert prdstmc.event_text(code) == jrdstmc.event_text(code)
        if qt is not None:
            assert prdstmc.event_text(code, 9) == jrdstmc.event_text(code, 9)
    assert prdstmc.event_text(1999) == jrdstmc.event_text(1999)
    for label in range(16):
        for value in (0, 1, 7, 31, 96 + 26, 201, 255):
            try:
                want = jrdstmc.format_quantifier(label, value)
            except Exception as e:  # the same refusal
                with pytest.raises(type(e)):
                    prdstmc.format_quantifier(label, value)
                continue
            assert prdstmc.format_quantifier(label, value) == want
    rng = np.random.default_rng(3)
    for _ in range(200):
        words = [int(w) for w in rng.integers(0, 1 << 28, rng.integers(1, 5))]
        assert prdstmc.parse_free_format(words) == jrdstmc.parse_free_format(words)
    assert prdstmc.QUANT_TYPES == jrdstmc.QUANT_TYPES
    assert prdstmc.LABEL_LENGTHS == jrdstmc.LABEL_LENGTHS


# -- RDS through the two BFM receivers ---------------------------------------------------

RATE = 384000.0
PI = 0xD3C2
PS = "SDRANGEL"
RADIOTEXT = "Broadcast FM with RDS through the port".ljust(64)
MJD, HOUR, MINUTE, TZ = 61269, 14, 30, 4  # 2026-08-17 14:30 UTC+2
TMC_EVENT, TMC_LOCATION = 501, 0x0C21


def rds_groups(pi: int = PI) -> list[list[int]]:
    """One cycle of 0A (PS, 4 groups), 2A (RadioText, 16 groups), 4A
    (clock-time) and 8A (a single-group TMC event: roadworks, 1 hour)."""
    groups = [[pi, (0 << 12) | (1 << 10) | (10 << 5) | seg, 0xE0CD,
               (ord(PS[2 * seg]) << 8) | ord(PS[2 * seg + 1])] for seg in range(4)]
    groups += [[pi, (2 << 12) | (10 << 5) | seg,
                (ord(RADIOTEXT[4 * seg]) << 8) | ord(RADIOTEXT[4 * seg + 1]),
                (ord(RADIOTEXT[4 * seg + 2]) << 8) | ord(RADIOTEXT[4 * seg + 3])]
               for seg in range(16)]
    groups.append([pi, (4 << 12) | (10 << 5) | ((MJD >> 15) & 0x3), ((MJD & 0x7FFF) << 1) | (HOUR >> 4),
                   ((HOUR & 0xF) << 12) | (MINUTE << 6) | TZ])
    groups.append([pi, (8 << 12) | (10 << 5) | (1 << 3) | 3,
                   (1 << 15) | (1 << 14) | (4 << 11) | TMC_EVENT, TMC_LOCATION])
    return groups


def rds_mpx(n: int, fs: float) -> np.ndarray:
    """The FM-modulated stereo MPX (L 1 kHz, R silent) with the RDS cycle on
    the 57 kHz subcarrier (tests/test_bfm.py's construction), complex64."""
    bits = np.concatenate([prds.encode_group(g) for g in rds_groups()]
                          * (int(n / fs * 1187.5 / 104 / 22) + 2))
    wave8 = prds.bits_to_waveform(bits, sps=8)
    idx = (np.arange(n) * 9500.0 / fs).astype(np.int64)
    t = np.arange(n) / fs
    left = 0.9 * np.sin(2 * np.pi * 1000.0 * t)
    mpx = test_bfm._make_mpx(fs, n, left, np.zeros(n), rds_wave=wave8[idx])
    return test_bfm._fm_modulate(mpx, fs)


def test_rds_through_bfm_equals_jax():
    cfg_kw = dict(channel_rate=RATE, squelch_db=-100.0, rds_active=True)
    jcfg, pcfg = jbfm.BFMConfig(**cfg_kw), pbfm.BFMConfig(**cfg_kw)
    block = jcfg.mono_plan.block_in
    assert pcfg.mono_plan.block_in == block
    n_blocks = int(1.3 * RATE) // block
    x = rds_mpx(n_blocks * block, RATE)
    run = jax.jit(jbfm.process, static_argnums=2)
    jstate, pstate = jbfm.make_state(jcfg), pbfm.make_state(pcfg, CPU)
    jdec, pdec = prds.RDSDecoder(sps=8), prds.RDSDecoder(sps=8)
    jgroups, pgroups = [], []
    for b in range(n_blocks):
        xb = x[b * block:(b + 1) * block]
        jstate, jout = run(jstate, jnp.asarray(xb), jcfg)
        pstate, pout = pbfm.process(pstate, torch.from_numpy(xb), pcfg)
        jbb = np.asarray(jout.rds_baseband)
        pbb = pout.rds_baseband.numpy()
        if np.any(jbb):  # the first block's is all zeros in both
            assert agreement_db(np.stack([jbb.real, jbb.imag]),
                                np.stack([pbb.real, pbb.imag])) >= 80.0, b
        else:
            assert not np.any(pbb)
        jgroups += jdec.feed_baseband(jbb)
        pgroups += pdec.feed_baseband(pbb)
    assert pgroups == jgroups and len(jgroups) >= 8
    assert dataclasses.asdict(pdec.status) == dataclasses.asdict(jdec.status)
    st = pdec.status  # 1.3 s holds ~15 of the cycle's 22 groups
    assert st.pi == PI and st.pty == 10 and st.ps_name.endswith(PS[2:])
    assert st.radiotext.startswith(RADIOTEXT[:16])
