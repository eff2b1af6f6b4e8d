"""chip_smoke.py's readers of the built kernels, on the CPU: the SASS
critical-path reader on hand-written SASS (the fast path kept, a slow path
dropped, merging paths taking the later ready time, a loop with no fast
path refused), ptxas's report mapped to K-PLL's kernels, and the names and
unrolls the script reads from pll_scan.cu."""

import re

import numpy as np
import torch

import pytest

import chip_smoke as cs

_HEAD = "\t\tFunction : _ZN12_GLOBAL__N_116pll_chain_kernelEPKfS1_Pfixff\n"


def _sass(body: list[str]) -> str:
    return _HEAD + "".join(f"        /*{16 * i:04x}*/  {ins} ;  /* 0x0 */\n"
                           for i, ins in enumerate(body))


def _loop(slow_ins: str) -> list[str]:
    """A loop from 0x10 to 0xa0: a fast arm of three dependent ops, and an
    arm that starts with `slow_ins` and adds three more to the carried R2."""
    return ["MOV R1, c[0x0][0x28]", "FADD R2, R2, R3", "@P0 BRA 0x60", "FADD R2, R2, R4",
            "FMUL R2, R2, R5", "BRA 0x90", slow_ins, "FADD R2, R2, R6", "FADD R2, R2, R6",
            "ISETP.NE.AND P1, PT, R7, RZ, PT", "@P1 BRA 0x10", "EXIT"]


@pytest.mark.parametrize("slow_ins,want,ops", [
    ("CALL.REL.NOINC 0x200", 3 * cs.DEP_LATENCY, 4),  # the slow arm is dropped
    ("LDL R9, [R1]", 3 * cs.DEP_LATENCY, 4),  # local memory: a slow arm too
    ("FADD R2, R2, R6", 4 * cs.DEP_LATENCY, 7),  # two fast arms: the later one holds
])
def test_sass_reader_keeps_the_fast_path(slow_ins, want, ops):
    """The carried R2's ready time over one pass, and the ops on the paths
    kept (a slow arm's are not counted)."""
    assert cs.sass_chain_cycles(_sass(_loop(slow_ins)), "16pll_chain_kernel", 1) == (want, ops)


def test_sass_reader_divides_by_the_unroll_and_refuses_an_all_slow_loop():
    sass = _sass(_loop("CALL.REL.NOINC 0x200"))
    assert cs.sass_chain_cycles(sass, "16pll_chain_kernel", 4)[0] == 3 * cs.DEP_LATENCY / 4
    all_slow = sass.replace("BRA 0x60", "BRA 0x30").replace("FADD R2, R2, R4", "CALL.REL 0x200")
    with pytest.raises(RuntimeError, match="every path"):
        cs.sass_chain_cycles(all_slow.replace("@P0 BRA 0x30", "BRA 0x30"), "16pll_chain_kernel", 1)


def test_kpll_names_and_unrolls_come_from_the_source():
    src = open(cs.KPLL_SOURCE).read()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)
    assert sorted(kernels) == sorted(cs.KPLL_KERNELS)
    assert set(cs.KPLL_SERIAL.values()) <= set(kernels)
    unroll = cs.kpll_unroll()
    assert unroll["pll_run"] == int(re.search(r"kChainUnroll = (\d+);", src).group(1))
    assert unroll["ref_pll_run"] == unroll["pilot_pll_run"] == int(
        re.search(r"kUnroll = (\d+);", src).group(1))


def test_ptxas_report_names_each_kpll_kernel():
    mangled = {"pll_detect_kernel": "17pll_detect_kernelEPK6float2Pfix",
               "pll_chain_kernel": "16pll_chain_kernelEPKfPK6float2PfS5_ixff",
               "pll_carrier_kernel": "18pll_carrier_kernelEPKfP6float2ix",
               "ref_pll_kernel": "14ref_pll_kernelEPK6float2PS0_Pfixfffff",
               "pilot_pll_kernel": "16pilot_pll_kernelEPKfPfS2_ixfffffff"}
    report = "".join(
        f"ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__ada0e6f6_11_pll_scan_cu_"
        f"75ddcc4d{m}' for 'sm_90a'\nptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {20 + i} registers, used 0 barriers\n"
        for i, m in enumerate(mangled.values()))
    lines = cs.ptxas_summary(report)
    assert [line.split(":")[0] for line in lines] == list(mangled)
    assert all(" 0 bytes spill stores" in line for line in lines)


def test_phase_codec_runs_on_the_host():
    """Phase 11d needs no card: the native and NumPy GF(256) codecs agree on
    one superframe and make_superframe equals the plain re-encode."""
    times = cs.phase_codec("CPU")
    assert times["encode"] > 0 and times["decode"] > 0


def test_plain_superframe_tracks_the_wire_format():
    """The re-encode phase 11d holds make_superframe to: every datagram,
    with and without parity, at an empty and at a full payload."""
    from sdrangel_tpu_torch.io import daemon

    room = (daemon.DATA_BLOCKS - 1) * daemon.BLOCK_BYTES
    for payload, n_fec in ((b"", 0), (bytes(range(256)) * (room // 256), 4),
                           (b"\x01" * room, 16)):
        assert daemon.make_superframe(3, payload, n_fec) == cs.plain_superframe(3, payload, n_fec)


def test_ts_check_finds_the_group_head():
    """Phase 11a's check: recovered packets must equal the sent stream from
    one scrambler-group head (a multiple of 8) on, with RS failing nowhere."""
    sent = cs.ts_stream(80, seed=1)
    assert sent.shape == (80, 188) and (sent[:, 0] == 0x47).all()
    got = sent[16:60].tobytes()
    stats = {"packets": 44, "rsFailed": 0}
    assert cs.ts_check(got, stats, sent, "test") == 16
    with pytest.raises(RuntimeError, match="group heads"):
        cs.ts_check(sent[12:60].tobytes(), {"packets": 48, "rsFailed": 0}, sent, "test")
    with pytest.raises(RuntimeError, match="rsFailed"):
        cs.ts_check(got, {"packets": 44, "rsFailed": 1}, sent, "test")


def test_rds_group_cycle_decodes_to_what_phase_12a_checks():
    """Phase 12a's group cycle through the port's encoder and decoder
    alone (no receiver): the PI, PTY, PS, RadioText, clock-time and TMC
    event the phase requires, none of its blocks corrected."""
    cycle = cs.rds_group_cycle()
    assert len(cycle) == 22
    bits = np.concatenate([cs.rds.encode_group(g) for g in cycle] * 2)
    dec = cs.rds.RDSDecoder(sps=8)
    dec.feed_baseband(cs.rds.bits_to_waveform(bits, sps=8).astype(np.complex64))
    st = dec.status
    assert (st.pi, st.pty, st.ps_name, st.radiotext, st.clock_time) == (
        cs.RDS_PI, cs.RDS_PTY, cs.RDS_PS, cs.RDS_RADIOTEXT, cs.RDS_CLOCK)
    ev = st.tmc_events[-1]
    assert (ev["event"], ev["event_text"], ev["location"]) == (
        cs.TMC_EVENT, cs.rdstmc.event_text(cs.TMC_EVENT), cs.TMC_LOCATION)
    assert st.blocks_corrected == 0 and st.groups_ok >= 40


def test_rds_capture_carries_the_subcarrier_coherent_with_the_pilot(monkeypatch):
    """rds_bfm_blocks on the CPU at a short block: the FM phase is
    continuous across blocks, the demodulated MPX holds the pilot, and
    the RDS subcarrier adds energy around 57 kHz (against the same capture
    without it)."""
    rate, block = 1_000_000.0, 1 << 16

    def mpx_band(level: float) -> tuple[float, float, np.ndarray]:
        monkeypatch.setattr(cs, "RDS_LEVEL", level)
        a, b = cs.rds_bfm_blocks(torch.device("cpu"), 2, block, rate)
        iq = np.concatenate([a, b]).astype(np.float64)
        z = iq[:, 0] + 1j * iq[:, 1]
        mpx = np.angle(z[1:] * np.conj(z[:-1])) * rate / (2 * np.pi * 75_000.0)
        spec = np.abs(np.fft.rfft(mpx * np.hanning(len(mpx)))) ** 2
        f = np.fft.rfftfreq(len(mpx), 1 / rate)
        band = lambda lo, hi: float(spec[(f > lo) & (f < hi)].sum())
        return band(55_500, 58_500), band(18_990, 19_010) / band(20_000, 21_000), mpx

    rds_on, pilot, mpx = mpx_band(cs.RDS_LEVEL)
    rds_off, _, _ = mpx_band(0.0)
    assert np.abs(np.diff(mpx[block - 8:block + 8])).max() < 0.5  # no seam at the join
    assert pilot > 100.0 and rds_on > 100.0 * rds_off
