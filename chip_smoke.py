"""Drive the PyTorch port's Rx product path, its channel-bank gear, its
receivers, Tx, data channels, DATV and daemon transport, RDS, network
egress and ingest, reference presets, library, mesh gears and every capture
format and placement once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own line; every number carries the card's name and
power limit as nvidia-smi reports them):
  0. device and precision: the card, its power limit, the TF32 flags;
  1. build: K1 (kernels/csrc/flat_decimate.cu), K1-TC
     (kernels/csrc/flat_decimate_tc.cu) and K-PLL (kernels/csrc/pll_scan.cu)
     with nvcc for sm_90a; ptxas's registers and spills (a spill of any
     variant of any of them fails), K1's and K1-TC's shared memory per block
     and resident blocks per SM, the critical path per step of each K-PLL
     entry's serial kernel (pll_run's pll_chain_kernel) from cuobjdump -sass;
  2. K1 against its plain twin on the card, the block and its tail as two
     tensors: i16 real legs, f32 real legs and f32 complex legs (inf and
     sup) at ÷4/÷16/÷64 on the 10,240,000-sample product block; each
     form's time at ÷64 beside its bound and its conv1d; three streamed
     blocks of 39,977 outputs (no multiple of the tile) equal one long
     block bit for bit;
  2b. K1-TC against its plain version on the card: i16 cen at ÷4/÷16/÷64 on
     the product block and on the 2^25-sample gear block, the block and its
     tail as two tensors (the gear's call), three streamed blocks of an
     output count that is no multiple of 128 against one long block, the
     MXU counterpart against K1 on one raw block; per-block times of K1-TC,
     K1, the plain version and conv1d;
  3. the product path: RxPipeline on cuda, 10 MS/s i16, ÷64 cen, NFM at
     +20 kHz, 8 blocks of continuous FM, timed twin, K1, K1, twin; K1
     launched once per block, the 1 kHz tone above 25 dB, and ≥ 80 dB
     agreement with the runs whose decimator is the plain twin;
  4. the CLI on cuda at 768 kS/s ÷2 with the channel at +100 kHz;
  5. the bank gear (parallel/sharded.py) at the bench's chainsharded width:
     12.288 MS/s i16, 2^25-sample blocks, ÷64 cen on K1-TC, PFB-4, 16 NFM
     (squelch −100 dB, gate 1 ms) at the bench's offsets; 3 continuous
     blocks of FM carriers at two demods' offsets, timed K1-TC, plain,
     plain, K1-TC; K1-TC launched once per block, the tone above 25 dB,
     all 16 streams finite, ≥ 80 dB agreement with the plain-decimator runs;
  6. the other receivers: RxPipeline on cuda with one AM (10 MS/s i16 ÷64,
     +20 kHz, a 1 kHz tone at 80 % depth), one SSB (÷64, USB 1 kHz above a
     −20 kHz carrier) and one WFM channel (÷32, 250 kHz request, a 1 kHz
     tone at 75 kHz deviation), 6 blocks each at their device blocks
     (10,240,000, 20,480,000, 10,240,000), timed twin, K1, K1, twin; per
     kind K1 launched once per block, the tone above 25 dB, ≥ 80 dB against
     the twin path and against the CPU pipeline on the first 2 blocks;
  7. the REST server: phase 3's first 6 blocks written to a .sdriq with the
     port's SdriqWriter, the port's server started in this process on
     127.0.0.1 with a Session on cuda, and driven over HTTP only: a device
     set playing the capture (÷64, run_blocks 6, publish_every 1) with an
     NFM channel at +20 kHz (squelch −60 dB), run to idle, its reports and
     its audio WAV read back; once streaming from the file and once with
     file_preload. K1 launched 6 times in each run, the tone above 25 dB,
     preload audio equal to streaming audio bit for bit, ≥ 80 dB against
     RxPipeline.run on the same blocks, the set idle with no error; each
     run's ms per block and real-time factor from the device report, and
     the streaming feed's ms per block alone;
  8. the Tx path (no kernel of its own; K1 only in the loopback):
     (a) TxPipeline on cuda at 9.6 MS/s ×64, NFM at +20 kHz, a 1 kHz tone,
         52 AF blocks of 4096 (819,200 device samples each), timed on the
         host clock around a synchronize after a warm-up of 4 blocks; each
         stage alone timed by CUDA events (the stream's elapsed time, which
         for these launch-bound stages is the host's launch time); the
         host's pieces alone (AF, upload, enqueue, read-back, a pinned
         allocation of the read-back's size); the device busy time of 8
         blocks by torch.profiler; the first 2 blocks
         on the CPU: int16 within 1 LSB and ≥ 80 dB;
     (b) the loopback: the 52 blocks written with SdriqWriter and decoded
         by RxPipeline on cuda at 9.6 MS/s ÷64, NFM at +20 kHz, three
         13,107,200-sample blocks; K1 launched once per Rx block, the tone
         above 25 dB;
     (c) four channels (NFM −50 and +50 kHz, AM +20 kHz, SSB −20 kHz: three
         groups, the sum/÷n merge), 2 blocks on the card against the CPU;
     (d) the `mod` CLI on cuda for 1 s at 384 kS/s ×1 (two UpChannelizer
         stages) against TxPipeline in this process;
     (e) a Tx device set over HTTP (the server in this process, a Session
         on cuda, NFM, 9.6 MS/s ×64, a filesink), stopped after 20 blocks
         by polling blocksProcessed: the .sdriq header and sample count,
         the set idle with no error, its samples equal to (a)'s.
  9. the NFM CTCSS and AF squelch, sync-AM and broadcast-FM slice (K-PLL,
     kernels/csrc/pll_scan.cu, the per-sample loops of dsp/phaselock.py):
     (a) K-PLL against its plain loop on the card, bit for bit: all three
         entry points at 16 × 4,096 samples (pll_run's input gated: a
         leading run of exact zeros, a zeroed stretch mid-block), pll_run
         and ref_pll_run at 16 × 49,152 against the plain loop on the CPU
         (dB over the block and the end phase's error); each entry point's
         time by CUDA events at 1 × 49,152 (the main path's) and 16 ×
         49,152, each kernel of the call alone by torch.profiler (pll_run's
         detector, chain and carrier), beside its bound (bytes or
         operations) and its latency bound: T × the cycles of one step's
         critical path, read from cuobjdump -sass (`sass_chain_cycles`);
     (b) sync AM on the product path: 10 MS/s i16 ÷64, AM at +20 kHz (1 kHz
         at 80 % depth), `sync_am` with USB and then DSB, 6 blocks of
         10,240,000: K1 and K-PLL once per block, the tone above 25 dB, ≥ 80
         dB against the CPU pipeline on the first 2 blocks;
     (c) NFM CTCSS and the delta squelch: the port's Tx NFM with a 88.5 Hz
         CTCSS tone at 9.6 MS/s ×64 (noise added to the capture), decoded at
         ÷64 over 3 blocks of 13,107,200 by one pipeline of four channels:
         ctcss_index 8 open with the tone above 25 dB, ctcss_index 9 silent
         after the first block, the delta squelch open on the carrier and
         shut on a noise-only channel; K1 once per block;
     (d) broadcast FM: 10 MS/s i16 ÷32, a stereo MPX (L 1 kHz, R silent, a
         10 % pilot, 75 kHz deviation), 6 blocks of 10,240,000: K1 once per
         block, the left tone above 25 dB, the right 20 dB under it, the
         pilot level above its lock level, ≥ 80 dB against the CPU pipeline
         on 2 blocks;
     (e) broadcast FM over HTTP: (d)'s blocks as a .sdriq played by a device
         set of the server on a cuda Session: the WAV's left channel equals
         RxPipeline.run's.
  10. the data channels (no kernel of their own; K1 in front):
     (a) set A at full width: 10.24 MS/s i16 ÷32 (320 kS/s; at 10 MS/s ÷32
         the block solver needs 204.8 M device samples), one RxPipeline of
         LoRa (SF9, 125 kHz, +80 kHz), DSD (DMR voice bursts as 4FSK,
         ±5.4 kHz, −40 kHz), the channel analyzer (5 kHz, a tone at +5
         kHz) and UDPSrc (nfm, a 1 kHz tone at 3 kHz deviation, −90 kHz),
         made on the card, 6 blocks of 26,214,400 (the DSD symbol-clock
         phase from a sweep on one block, see dsd_symbol_phase): K1 once
         per block; LoRa's symbols within a bin of the modal offset on ≥ 99
         % of frames; DSD's dibits at the best lag on ≥ 99 %, the host frame
         sync finding ≥ 95 % of the DMR syncs sent; the analyzer's power
         within 0.5 dB of the tone's; UDPSrc's tone above 25 dB; ≥ 80 dB
         card against CPU on 2 blocks with the integer outputs equal; each
         layer of a block alone and the device time by torch.profiler;
     (b) set B: a PAL 625/25 picture (a ramp and bars) from the port's
         atv_modulate at 20 MS/s, ÷2, the ATV receiver, 5 blocks of
         327,680: K1 once per block, the sync phase constant, the notch
         deeper than 0.3, the mean line against the test frame ρ > 0.95,
         ≥ 80 dB card against CPU;
     (c) set A's first 3 blocks as a .sdriq played by `python -m
         sdrangel_tpu_torch server --device cuda` in its own process over
         HTTP: each data route within one 5-place rounding step of the
         pipeline's third block, dataBlocks 3, the DSD report equal to the
         frame sync of the pipeline's dibits.
  11. the GF(256) layer's paths (no kernel of their own; K1 in front):
     (a) DATV at full width: DVB-S at 250 kS/s QPSK, FEC 1/2 (the
         reduced-bandwidth class amateur DATV stations transmit), carrying
         PAT, PMT and an H.264 PES of programme 7 between random packets,
         encoded by the port's dvbs and tsdemux, shaped with
         create_rrc_filter (rolloff 0.35) on the card at Es/N0 10 dB in an
         8 MS/s int16 capture; RxPipeline ÷8 to the channel's 1 MS/s (4
         samples a symbol), 4 blocks of 8,388,608 (~1 s): K1 once per
         block; the host FEC (recover_ts) over the first 2 blocks' soft
         symbols, timed: RS fails on no packet, the packets equal the sent
         ones from a group head on, the demux finds programme 7's H.264
         stream; a shorter FEC 3/4 capture recovers likewise; ≥ 80 dB card
         against CPU on 2 blocks; the device's busy share by torch.profiler;
     (b) (a)'s first block as a .sdriq through `python -m
         sdrangel_tpu_torch server --device cuda` in its own process: a
         DATV channel with datvContinuous over 16 session blocks, its report
         polled through the run (each pass's host seconds: the worker's
         stall); rounds ≥ 1, packets > 100, rsFailed 0, programme 7, and
         /data carrying soft_i/soft_q;
     (c) the daemon loopback: the remote radio, a Tx set on the card in a
         `server` process of its own (NFM +20 kHz, a 1 kHz tone, 5 kHz
         deviation, 1.536 MS/s ×8) into a daemonsink with 16 parity
         blocks, a relay process dropping every 32nd datagram, and in this
         process an Rx set on the card whose daemonsource feeds K1 ÷4 and
         NFM at +20 kHz:
         K1 once per Rx block, blocks recovered, no frame failed after the
         first second, the tone above 25 dB over the longest active run of
         ≥ 2 s, the native codec built; superframes and datagrams a second;
     (d) the codec alone: native and NumPy GF(256) byte-equal on one
         superframe (128 × 512 B, 16 parity blocks, 16 erasures), their
         host times, and make_superframe's datagrams against a plain
         re-encode.
  12. the last single-card modules (no kernel of their own; K1 in front):
     (a) RDS at broadcast width: phase 9d's stereo MPX plus an RDS subcarrier
         at 57 kHz coherent with the pilot, a 22-group cycle of 0A (PI, PS),
         2A (RadioText), 4A (clock-time) and 8A (a single-group TMC event),
         6 blocks of 10,240,000; K1 ÷32 (decimate_flat_raw), BFM with
         rds_active on the card, the RDS baseband read back per block into
         the port's RDSDecoder: K1 once per block, PI, PS, the RadioText,
         the clock-time and the TMC event's text as sent, the share of
         blocks corrected or failed, the left tone above 25 dB, the
         baseband ≥ 80 dB from the CPU chain on 2 blocks; ms/block, the
         device's busy time by torch.profiler and the host decoder's
         seconds per second of signal;
     (b) network egress from a cuda Session served in this process,
         playing phase 7's product capture (÷64, 6 blocks): NFM +20 kHz
         with audioUdp and audioRtp, UDPSrc iq16 at +20 kHz, all aimed at
         sockets of this process: K1 once per block, the UDP mono16
         datagrams within 1 LSB of the drained audio, the RTP packets L16
         mono in contiguous sequence with the UDP stream's samples and an
         RTCP SR, UDPSrc's datagrams byte for byte the iq16 of every block
         the set published, in order, and within 1 LSB of its /data, the
         audio route listing both destinations; datagrams a second;
     (c) Tx AF over UDP: a Tx set on the card (9.6 MS/s ×64, NFM +20 kHz,
         filesink) whose afUdp source takes a 1 kHz mono16 tone sent at
         48 kHz pace, 48 blocks; its capture through RxPipeline ÷64 on the
         card (3 blocks, K1 once per block): the tone above 25 dB;
     (d) reference presets: tests/goldens/refpreset.b64 imported over PUT
         /sdrangel/preset/file and loaded on a cuda Session (seven channels,
         their offsets and the front end as tests/test_refpreset.py
         asserts), run 3 blocks with K1 once per block, exported again with
         format reference, and read back by the port's parse_preset to the
         golden's four audio channels;
     (e) the library: decimate_flat_iq (one K1 f32 launch) at the gear block
         (2^25) and the product block against its plain version, equal to
         decimate_flat on the same samples as complex64, three streamed
         parts equal to one block, timed beside its bound and F.conv1d;
         fftcorr on the card against the CPU; `demod --device cuda --in` on
         the product capture through the native .sdriq loader (which must
         build) and through the memmap: the same WAV bytes, the loader's
         read time per block.
  13. the mesh gears (parallel/mesh.py; K1-TC and K1 on every shard):
     (a) phase 5's gear and blocks on a 2x2 mesh of four shards of the card
         against the 1x1 gear: max |d| <= 2e-5 in every block, and against
         the same mesh with K1-TC's plain version: >= 80 dB in every block;
         K1-TC once per shard and block (12 in 3), the tone above 25 dB at
         demods 5 and 6; the capture moved down by fs/64 (the inf passband)
         on a 2x1 mesh at fc_pos=inf against its 1x1 gear (2e-5) and
         against the same mesh with K1's plain version (80 dB), K1's
         complex legs 6 in 3; each timed 1x1, mesh, mesh, 1x1 in ms a block;
     (b) the all-to-all gear at (a)'s 2x2 width with four demods on each
         grid channel, against the all-gather gear (2e-5, audio
         un-permuted, K1-TC 12 in 3); bench.py's chain64a2a (÷1, PFB-256, 64
         NFM over 64 slots, 2^25 blocks of seeded uniform int16) on a 1x1
         mesh against the all-gather gear's same 64 channels; timed alike;
     (c) (a)'s capture as a .sdriq through `python -m sdrangel_tpu_torch
         server --device cuda`: a sharded set (1x1 mesh, PFB-4, 16 NFM,
         run_blocks 3), then the same with sharded_pfb_a2a: each channel's
         WAV what the direct step's audio quantizes to within 1e-6, the
         report's realtimeFactor and a2aFallback.
  14. the configurations no earlier phase runs (no kernel of their own; K1
     or K1-TC in front):
     (a) RxPipeline at 10 MS/s ÷64, NFM +20 kHz, 4 blocks of 10,240,000 of
         phase 3's FM made on the card (checked within 1 LSB of phase 3's
         block 0) as an RTL-SDR u8, a HackRF i8, a 12-bit and a 24-bit
         capture, as i16 with 5 % DC, gain and phase faults through the DC
         and IQ correction, and as i16 at fc_pos inf and sup with the
         carrier in the passband the placement schedule selects (∓fs/64):
         K1 once per block in its f32 real or complex-leg form, the tone
         above 25 dB, ≥ 80 dB against the CPU pipeline on 2 blocks; ms/block
         after one warm-up block, and the upload alone;
     (b) (a)'s u8 and i8 blocks as raw cu8 and cs8 captures and its i24
         blocks as a 24-bit .sdriq (streamed, then preloaded) through a
         cuda Session served in this process, run to idle over HTTP: K1
         once per block, each WAV what RxPipeline.run's audio quantizes to
         within 1e-6, the preloaded audio equal to the streamed; then `demod
         --device cuda --in` (in-process) on a 24-bit capture of the inf
         signal with --fc-pos inf --iq-correction against RxPipeline.run;
     (c) phase 5's gear on a 1x1 mesh at fc_pos=sup (phase 5's blocks moved
         up by fs/64 on the card) and with chan_stages=2 in place of the PFB
         (moved so demod 6's carrier sits in the centre 48 kHz), each against
         the same gear on the kernel's plain version (≥ 80 dB per block), K1's
         complex legs or K1-TC once per block, the tone above 25 dB.
     `python3 chip_smoke.py --phase 14` runs phase 14 alone, phase 3's first
     block and phase 5's blocks made anew, and prints no kernels or ok line.
Then a JSON line of the kernels, and last the ok line. Any failed check
raises: the script then exits non-zero and prints no ok line. It needs a
card; without one it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
import zlib

import numpy as np
import torch

import torch.nn.functional as F
from torch.autograd import DeviceType

import sdrangel_tpu_torch.dsp.decimators as dec
from sdrangel_tpu_torch.__main__ import main as cli_main
from sdrangel_tpu_torch.api.server import make_server
from sdrangel_tpu_torch.io import daemon, fec, native, rtp, sdriq, testsource, udp, wav
from sdrangel_tpu_torch.kernels import build
from sdrangel_tpu_torch.kernels import decimator as kdec
from sdrangel_tpu_torch.kernels import flat_decimate as k1_kernel
from sdrangel_tpu_torch.kernels import pll_scan
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
from sdrangel_tpu_torch.kernels.flat_decimate_tc import (
    RATIOS,
    blocks_per_sm,
    flat_decimate_tc,
    flat_decimate_tc_reference,
)
from sdrangel_tpu_torch.parallel import sharded
from sdrangel_tpu_torch.parallel.mesh import make_mesh
from sdrangel_tpu_torch.profile_product import (
    RECEIVERS,
    _device_time,
    chainsharded_config,
    chainsharded_offsets,
    receiver_pipeline,
)
from sdrangel_tpu_torch.channels import demod_bfm, demod_datv, dsdsync, dvbs, rds, rdstmc, tsdemux
from sdrangel_tpu_torch.channels.modulators import (
    ATVModConfig,
    atv_composite,
    atv_modulate,
    make_atv_state,
)
from sdrangel_tpu_torch.channels.registry import requested_rate
from sdrangel_tpu_torch.dsp import channelizer as chan
from sdrangel_tpu_torch.dsp import fftcorr, fftfilt
from sdrangel_tpu_torch.dsp import interpolators as interp
from sdrangel_tpu_torch.dsp import phaselock
from sdrangel_tpu_torch.dsp import scope as dsp_scope
from sdrangel_tpu_torch.dsp import spectrum as dsp_spectrum
from sdrangel_tpu_torch.dsp.types import complex_to_iq_raw
from sdrangel_tpu_torch.runtime.engine import (
    ChannelSpec,
    DeviceConfig,
    RxPipeline,
    fetch,
    pack_outs,
)
from sdrangel_tpu_torch.runtime import refpreset
from sdrangel_tpu_torch.runtime.session import DeviceSet, DsdHostSync, Session
from sdrangel_tpu_torch.runtime.tx import TxChannelSpec, TxDeviceConfig, TxPipeline

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 2e-5  # K1 vs twin, the Pallas kernel's own tolerance
PRODUCT_RATE = 10e6
PRODUCT_BLOCK = 10_240_000  # RxPipeline's device block at 10 MS/s ÷64 NFM
NFM = "sdrangel.channel.nfmdemod"
DEVICE = "cuda"
GEAR_RATE = 12_288_000.0  # bench.py chainsharded: 12.288 MS/s ÷64 -> 192 kHz
GEAR_BLOCK = 1 << 25
TX_RATE = 9.6e6  # phase 8: ×64 from a 150 kHz baseband, the mirror of ÷64
TX_BLOCK = 819_200  # device samples per 4096-sample AF block at 9.6 MS/s ×64
TX_BLOCKS = 52
TX_RX_BLOCK = 13_107_200  # RxPipeline's block at 9.6 MS/s ÷64 NFM
NFM_MOD = "sdrangel.channeltx.modnfm"
# published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): HBM bytes/s,
# FP32 outside the tensor cores and dense TF32 FLOP/s
HBM_BPS, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


def tone_snr(audio: np.ndarray, tone_hz: float, fs: float) -> float:
    audio = audio - audio.mean()
    n = len(audio)
    spec = np.abs(np.fft.rfft(audio * np.hanning(n))) ** 2
    tone = np.abs(np.fft.rfftfreq(n, 1.0 / fs) - tone_hz) < 4.0 * fs / n
    return float(10 * np.log10(spec[tone].sum() / max(spec[~tone].sum(), 1e-30)))


def agreement_db(ref: np.ndarray, ours: np.ndarray) -> float:
    err = ours.astype(np.float64) - ref.astype(np.float64)
    return float(10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                               / max(np.sum(err ** 2), 1e-300)))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fm_blocks(n_blocks: int, block: int, rate: float, carrier: float | tuple[float, ...],
              amplitude: float = 0.5) -> list[np.ndarray]:
    """Continuous FM (1 kHz tone, 5 kHz deviation) at each carrier, summed."""
    carriers = carrier if isinstance(carrier, tuple) else (carrier,)
    cfgs = [testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=c, modulation="fm", tone_freq=1000.0,
        fm_deviation=5000.0, amplitude=amplitude) for c in carriers]
    return [testsource.to_iq_int16(sum(testsource.generate(c, block, start_sample=b * block)
                                       for c in cfgs))
            for b in range(n_blocks)]


def decimator_bound(n_in: int, n_out: int, r: int, t_leg: int, tensor_cores: bool,
                    in_bytes: int = 4, complex_legs: bool = False) -> tuple[float, str]:
    """(ms, what bounds it): the least time for one ÷r decimation of n_in
    I/Q pairs of in_bytes each — its bytes (input read once, output written
    once) over HBM, against its arithmetic over the peak of its type: per
    output, r·t_leg FMA per plane with real legs (2 FLOP each, two planes),
    4 real FMA per complex sample and tap with complex legs, on FP32 for
    K1; for K1-TC one TF32 pass of them plus the (t_leg − 1)-add diagonal
    sum on FP32. K1-TC's three TF32 passes (the hi/lo splits that keep f32
    fidelity) are its design's cost, not work the function needs, so the
    bound counts one."""
    t_bytes = (n_in * in_bytes + n_out * 8) / HBM_BPS
    flop = n_out * r * t_leg * (8 if complex_legs else 4)
    if tensor_cores:
        t_ops = flop / TF32_FLOPS + n_out * 2 * (t_leg - 1) / FP32_FLOPS
    else:
        t_ops = flop / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def ptxas_summary(report: str) -> list[str]:
    """Each kernel's registers and spills from nvcc's -Xptxas -v report, as
    'flat_decimate_tc_kernel<Li6>: 149 registers, 0 bytes spill stores, ...'
    (K1-TC's template arguments as mangled; K1's as
    'flat_decimate_kernel<short2 r=64 real>')."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            mangled = m.group(1)
            if v := re.search(r"flat_decimate_kernelI.*Variant\w*?I\d+(short2|float2)Li(\d)ELb([01])",
                              mangled):
                name = (f"flat_decimate_kernel<{v.group(1)} r={1 << int(v.group(2))} "
                        f"{'complex' if v.group(3) == '1' else 'real'}>")
            elif k := re.search(r"\d(flat_decimate(?:_tc)?_kernel)I(.+?)EE+v", mangled):
                name = f"{k.group(1)}<{k.group(2)}>"
            elif k := re.search(r"\d((?:ref_|pilot_)?pll(?:_detect|_chain|_carrier)?_kernel)E",
                                mangled):
                name = k.group(1)
            else:
                name = mangled
            spill = ""
        elif name and "spill" in line:
            spill = line.split("stack frame,")[-1].strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def conv1d_planes(ext: torch.Tensor, legs: torch.Tensor, legs_im: torch.Tensor | None = None):
    """The library call computing the decimator: one F.conv1d over the f32
    polyphase planes (made outside the timed call), with the two weights
    (real and imaginary legs) that `flat_decimate_reference` stacks for
    complex legs."""
    r = legs.shape[0]
    x = ext.to(torch.float32)
    if ext.dtype == torch.int16:
        x = x * (1.0 / 32768.0)
    planes = x.reshape(-1, r, 2).permute(2, 1, 0).contiguous()
    weight = (legs[None] if legs_im is None else torch.stack([legs, legs_im])).contiguous()
    return lambda: F.conv1d(planes, weight)


# K1's three forms: (name, input dtype, placement of the legs)
K1_FORMS = (("i16 real", torch.int16, "cen"), ("f32 real", torch.float32, "cen"),
            ("f32 complex", torch.float32, "inf"))


def phase_k1(dev: torch.device, tag: str) -> dict:
    """K1 in the two-pointer form against its plain twin, each form timed
    beside its bound and its conv1d."""
    rng = np.random.default_rng(1234)
    worst = 0.0

    def compare(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite K1 output")
        check(err <= ATOL, f"{name}: K1 vs twin max abs {err:.3e} > {ATOL}")
        worst = max(worst, err)
        print(f"phase 2 k1 {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
              f"(atol {ATOL}) [{tag}]", flush=True)

    raw = torch.from_numpy(
        rng.integers(-32768, 32767, size=(PRODUCT_BLOCK, 2), endpoint=True, dtype=np.int16)
    ).to(dev)
    inputs = {torch.int16: raw, torch.float32: (raw.to(torch.float32) / 32768.0).contiguous()}
    forms = {}
    for log2 in (2, 4, 6):
        tail_i16 = torch.from_numpy(rng.integers(-32768, 32767, endpoint=True, dtype=np.int16,
                                                 size=(dec.flat_tail_len(log2), 2))).to(dev)
        tails = {torch.int16: tail_i16, torch.float32: tail_i16.to(torch.float32) / 32768.0}
        for name, dtype, fc_pos in K1_FORMS:
            legs_re, legs_im, _ = dec._device_legs(log2, fc_pos, dev)
            x, tail = inputs[dtype], tails[dtype]
            compare(f"{name} legs k={log2} block={PRODUCT_BLOCK} two-pointer vs twin",
                    flat_decimate(x, legs_re, legs_im, tail=tail),
                    flat_decimate_reference(x, legs_re, legs_im, tail=tail))
            if log2 != 6:
                continue
            t = {"ms": time_ms(lambda: flat_decimate(x, legs_re, legs_im, tail=tail)),
                 "plain_ms": time_ms(
                     lambda: flat_decimate_reference(x, legs_re, legs_im, tail=tail)),
                 "library_ms": time_ms(conv1d_planes(torch.cat([tail, x]), legs_re, legs_im))}
            t["bound_ms"], t["bound_by"] = decimator_bound(
                tail.shape[0] + x.shape[0], PRODUCT_BLOCK >> 6, 64, legs_re.shape[1],
                tensor_cores=False, in_bytes=x.element_size() * 2,
                complex_legs=legs_im is not None)
            print(f"phase 2 k1 time {name} legs k=6 block={PRODUCT_BLOCK}: K1 {t['ms']:.4f} ms "
                  f"(tail and block as two tensors), twin {t['plain_ms']:.4f} ms, conv1d alone "
                  f"{t['library_ms']:.4f} ms per block (CUDA events, 20 launches after 3 "
                  f"warm-up); bound {t['bound_ms']:.4f} ms by {t['bound_by']}, K1 at "
                  f"{100 * t['bound_ms'] / t['ms']:.1f} % of it [{tag}]", flush=True)
            forms[name] = t
        # the sup placement's complex legs (the CLI's --fc-pos sup, the
        # gear's sup route), checked and not timed: the inf form's variant
        legs_re, legs_im, _ = dec._device_legs(log2, "sup", dev)
        x, tail = inputs[torch.float32], tails[torch.float32]
        compare(f"f32 complex (sup) legs k={log2} block={PRODUCT_BLOCK} two-pointer vs twin",
                flat_decimate(x, legs_re, legs_im, tail=tail),
                flat_decimate_reference(x, legs_re, legs_im, tail=tail))

    # three streamed blocks (tail carried as raw int16, passed as its own
    # tensor) equal one long block bit for bit; a block is an output count
    # that is not a multiple of K1's 64-output tile, so outputs change their
    # place in a tile between the streamed and the long run
    legs, _, _ = dec._device_legs(6, "cen", dev)
    third = PRODUCT_BLOCK // 4 - 64 * 23
    blocks = [raw[i * third:(i + 1) * third].contiguous() for i in range(3)]
    state = dec.init_flat_state(6, dev, raw=True)
    parts = []
    for b in blocks:
        state, y = dec.decimate_flat_raw(state, b, 6)
        parts.append(torch.view_as_real(y))
    streamed = torch.cat(parts)
    zero_tail = dec.init_flat_state(6, dev, raw=True).tail
    long = flat_decimate(raw[:3 * third], legs, tail=zero_tail)
    long_twin = flat_decimate_reference(raw[:3 * third], legs, tail=zero_tail)
    torch.cuda.synchronize()
    err_stream = float((streamed - long).abs().max())
    err_stream_twin = float((streamed - long_twin).abs().max())
    check(err_stream == 0.0, f"K1 streamed vs long block differ by {err_stream:.3e}")
    check(err_stream_twin <= ATOL, f"streamed vs long block (twin): {err_stream_twin:.3e}")
    worst = max(worst, err_stream_twin)
    print(f"phase 2 k1 streaming 3x{third} ({third // 64} outputs each) vs one block: max abs "
          f"{err_stream:.3e} K1 vs K1, "
          f"{err_stream_twin:.3e} vs twin [{tag}]", flush=True)
    return {"max_abs_err": worst, **forms["i16 real"], "forms": forms}


def phase_k1_tc(dev: torch.device, tag: str) -> dict:
    """K1-TC against its plain Z-form version, at the product and gear blocks."""
    rng = np.random.default_rng(4321)
    worst = 0.0

    def compare(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite K1-TC output")
        err = float((got - want).abs().max())
        check(err <= ATOL, f"{name}: max abs {err:.3e} > {ATOL}")
        worst = max(worst, err)
        print(f"phase 2b k1-tc {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
              f"(atol {ATOL}) [{tag}]", flush=True)

    timings = {}
    for block in (PRODUCT_BLOCK, GEAR_BLOCK):
        raw = torch.from_numpy(rng.integers(-32768, 32767, size=(block, 2), endpoint=True,
                                            dtype=np.int16)).to(dev)
        for log2 in (2, 4, 6):
            legs, _, _ = dec._device_legs(log2, "cen", dev)
            tail = torch.from_numpy(rng.integers(-32768, 32767, endpoint=True, dtype=np.int16,
                                                 size=(dec.flat_tail_len(log2), 2))).to(dev)
            # the gear's call: the block and its carried tail as two tensors
            compare(f"i16 cen k={log2} block={block} two-pointer vs plain",
                    flat_decimate_tc(raw, legs, tail=tail),
                    flat_decimate_tc_reference(raw, legs, tail=tail))
            if log2 != 6:
                continue
            ext = torch.cat([tail, raw])  # K1's and conv1d's one-tensor input
            t = {"ms": time_ms(lambda: flat_decimate_tc(raw, legs, tail=tail)),
                 "k1_ms": time_ms(lambda: flat_decimate(ext, legs)),
                 "plain_ms": time_ms(lambda: flat_decimate_tc_reference(raw, legs, tail=tail)),
                 "library_ms": time_ms(conv1d_planes(ext, legs))}
            t["bound_ms"], t["bound_by"] = decimator_bound(
                ext.shape[0], block >> 6, 64, legs.shape[1], tensor_cores=True)
            print(f"phase 2b k1-tc time i16 cen k=6 block={block}: K1-TC {t['ms']:.4f} ms "
                  f"(tail and block as two tensors), K1 {t['k1_ms']:.4f} ms, plain (Z-form) "
                  f"{t['plain_ms']:.4f} ms, conv1d alone {t['library_ms']:.4f} ms per block "
                  f"(CUDA events, 20 launches after 3 warm-up); K1-TC bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}, K1-TC at "
                  f"{100 * t['bound_ms'] / t['ms']:.1f} % of it [{tag}]", flush=True)
            timings[block] = t
        if block == GEAR_BLOCK:
            # the MXU counterpart against K1 on one raw block (HALO convention)
            halo_raw = torch.cat([torch.zeros((kdec.HALO, 2), dtype=torch.int16, device=dev),
                                  raw])
            compare(f"decimate_cascade_fused_mxu vs decimate_cascade_fused (K1) k=6 "
                    f"block={block}", kdec.decimate_cascade_fused_mxu(halo_raw, 6),
                    kdec.decimate_cascade_fused(halo_raw, 6))
            # three streamed blocks, each with the previous one's raw tail as
            # its own tensor, equal one long block; a block is an output count
            # that is not a multiple of the 128-output tile
            legs, _, _ = dec._device_legs(6, "cen", dev)
            tail_len = dec.flat_tail_len(6)
            size = ((block // 4) // 64 - 37) * 64
            tail = torch.zeros((tail_len, 2), dtype=torch.int16, device=dev)
            long = flat_decimate_tc(raw[:3 * size], legs, tail=tail)
            long_plain = flat_decimate_tc_reference(raw[:3 * size], legs, tail=tail)
            parts = []
            for i in range(3):
                b = raw[i * size:(i + 1) * size]
                parts.append(flat_decimate_tc(b, legs, tail=tail))
                tail = b[size - tail_len:].clone()
            parts = torch.cat(parts)
            torch.cuda.synchronize()
            err = float((parts - long).abs().max())
            check(err == 0.0, f"K1-TC streamed vs long block differ by {err:.3e}")
            compare(f"streaming 3x{size} vs one long block (plain)", parts, long_plain)
            print(f"phase 2b k1-tc streaming 3x{size} ({size // 64} outputs each) vs one long "
                  f"block: max abs {err:.3e} K1-TC vs K1-TC [{tag}]", flush=True)
    return {"max_abs_err": worst, **timings[GEAR_BLOCK], "product": timings[PRODUCT_BLOCK]}


def run_product(pipe: RxPipeline, blocks: list[np.ndarray]) -> tuple[np.ndarray, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = [outs["channels"][0]["audio"] for _, outs in pipe.run(lambda b, n: blocks[b],
                                                                   len(blocks))]
    torch.cuda.synchronize()
    return np.concatenate(audio), time.perf_counter() - t0


@contextlib.contextmanager
def plain_decimator():
    """The same product path with K1's plain twin as the device decimator."""
    real_kernel = dec.flat_decimate
    dec.flat_decimate = flat_decimate_reference
    try:
        yield
    finally:
        dec.flat_decimate = real_kernel


def phase_product(pipe: RxPipeline, tag: str) -> tuple[int, list[np.ndarray]]:
    n_blocks = 8
    check(pipe.device_block == PRODUCT_BLOCK, f"device block {pipe.device_block}")
    t0 = time.perf_counter()
    blocks = fm_blocks(n_blocks, PRODUCT_BLOCK, PRODUCT_RATE, 20_000.0)
    print(f"phase 3 product: generated {n_blocks} blocks of {PRODUCT_BLOCK} i16 samples on "
          f"the host in {time.perf_counter() - t0:.2f} s (set-up, not timed) [{tag}]", flush=True)
    # warm-up of both paths: cuFFT plans, cuDNN choices, the kernel library
    list(pipe.run(lambda b, n: blocks[b], 2))
    with plain_decimator():
        list(pipe.run(lambda b, n: blocks[b], 2))

    signal_s = n_blocks * PRODUCT_BLOCK / PRODUCT_RATE
    seconds = {"K1": [], "twin": []}
    for path in ("twin", "K1", "K1", "twin"):  # alternated, so drift cancels
        if path == "K1":
            flat_decimate.launches = 0
            audio, elapsed = run_product(pipe, blocks)
            launches = flat_decimate.launches
            check(launches == n_blocks, f"K1 launched {launches} times for {n_blocks} blocks")
        else:
            with plain_decimator():
                twin_audio, elapsed = run_product(pipe, blocks)
        seconds[path].append(elapsed)
        print(f"phase 3 product ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
              f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
              f"{signal_s / elapsed:.2f}, {n_blocks * PRODUCT_BLOCK / elapsed / 1e6:.1f} MS/s "
              f"input [{tag}]", flush=True)

    check(bool(np.isfinite(audio).all()), "non-finite audio")
    check(audio.shape == (n_blocks * 49_152,), f"audio shape {audio.shape}")
    snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"product-path tone SNR {snr:.1f} dB")
    agree = agreement_db(twin_audio, audio)
    check(agree >= 80.0, f"K1 path vs twin path audio agreement {agree:.1f} dB")
    k1_s, twin_s = (sum(seconds[k]) / 2 for k in ("K1", "twin"))
    print(f"phase 3 product: K1 path {k1_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
          f"{signal_s / k1_s:.2f}), twin path {twin_s / n_blocks * 1e3:.3f} ms/block "
          f"({signal_s / twin_s:.2f}), mean of 2 runs each; K1 launches {launches} in the "
          f"last K1 run; tone SNR {snr:.2f} dB; K1 vs twin audio agreement {agree:.2f} dB "
          f"[{tag}]", flush=True)
    return launches, blocks


def phase_cli(tag: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.wav")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdrangel_tpu_torch", "demod", "--device", DEVICE,
             "--test-fm", "1000", "--rate", "768000", "--log2-decim", "1",
             "--channel", "nfm:100000", "--squelch", "-60", "--seconds", "1.1",
             "--out", out],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        elapsed = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exit {proc.returncode}:\n{proc.stderr}")
        data, fs = wav.read_wav(out)
    audio = data[:, 0].astype(np.float64)[len(data) // 2:] / 32768.0
    snr = tone_snr(audio, 1000.0, fs)
    check(snr > 25.0, f"CLI tone SNR {snr:.1f} dB")
    print(f"phase 4 cli: demod --device cuda 768 kS/s /2 nfm:100000 exit 0 in {elapsed:.2f} s "
          f"(process start included), {len(data)} audio samples, tone SNR {snr:.2f} dB "
          f"[{tag}]", flush=True)
    print("phase 4 cli stderr: " + proc.stderr.strip().replace("\n", " | "), flush=True)


@contextlib.contextmanager
def plain_tc_decimator():
    """The bank gear with K1-TC's plain version as its decimator."""
    real_kernel = sharded.flat_decimate_tc
    sharded.flat_decimate_tc = flat_decimate_tc_reference
    try:
        yield
    finally:
        sharded.flat_decimate_tc = real_kernel


def phase_bank(dev: torch.device, tag: str) -> tuple[int, list[torch.Tensor]]:
    """Phase 5; returns K1-TC's launches and the capture's blocks on the card."""
    n_blocks = 3
    cfg = chainsharded_config()
    check(cfg.device_rate == GEAR_RATE and cfg.block == GEAR_BLOCK, "gear configuration")
    offs = chainsharded_offsets(cfg)
    idx, res = sharded.grid_split(cfg, offs)
    # one carrier in each used grid channel, so every demod holds a strong
    # signal: at demod 5's offset (grid 3) and demod 6's (grid 1)
    tone_demods = (5, 6)
    t0 = time.perf_counter()
    blocks = fm_blocks(n_blocks, GEAR_BLOCK, GEAR_RATE,
                       tuple(float(offs[k]) for k in tone_demods), amplitude=0.35)
    print(f"phase 5 bank: generated {n_blocks} blocks of {GEAR_BLOCK} i16 samples on the host "
          f"in {time.perf_counter() - t0:.2f} s (set-up, not timed); carriers at "
          f"{[float(offs[k]) for k in tone_demods]} Hz; grid {idx.tolist()}, residuals "
          f"{res.tolist()} Hz [{tag}]", flush=True)
    t0 = time.perf_counter()
    step, init_fn = sharded.build_sharded_step(cfg, dev)
    res_t, idx_t = torch.from_numpy(res).to(dev), torch.from_numpy(idx).to(dev)
    xs = [torch.from_numpy(b).to(dev) for b in blocks]  # the capture, resident on the card
    torch.cuda.synchronize()
    print(f"phase 5 bank: built and uploaded in {time.perf_counter() - t0:.2f} s [{tag}]",
          flush=True)

    def run():
        state, carry = init_fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = []
        for x in xs:
            state, a, carry = step(state, x, carry, res_t, idx_t)
            audio.append(a)
        out = torch.cat(audio, dim=-1).cpu().numpy()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    run()  # warm-up of both paths: cuFFT plans, the kernel library
    with plain_tc_decimator():
        run()
    signal_s = n_blocks * GEAR_BLOCK / GEAR_RATE
    seconds = {"K1-TC": [], "plain": []}
    # alternated, so drift cancels; K1-TC first (phase 3 runs the plain path
    # first), so a first-timed-run effect shows on either path
    order = ("K1-TC", "plain", "plain", "K1-TC")
    for path in order:
        if path == "K1-TC":
            flat_decimate_tc.launches = 0
            audio, elapsed = run()
            launches = flat_decimate_tc.launches
            check(launches == n_blocks, f"K1-TC launched {launches} times for {n_blocks} blocks")
        else:
            with plain_tc_decimator():
                plain_audio, elapsed = run()
        seconds[path].append(elapsed)
        print(f"phase 5 bank ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
              f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
              f"{signal_s / elapsed:.2f} (capture resident on the card; audio fetched) "
              f"[{tag}]", flush=True)

    per_block = cfg.demod_cfg.resampler_plan.block_out
    check(audio.shape == (16, n_blocks * per_block), f"bank audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), "non-finite bank audio")
    snrs = [tone_snr(audio[k, audio.shape[1] // 2:].astype(np.float64), 1000.0, 48_000.0)
            for k in tone_demods]
    check(min(snrs) > 25.0, f"bank tone SNR {snrs} dB")
    agree = agreement_db(plain_audio, audio)
    per_channel = [agreement_db(plain_audio[k], audio[k]) for k in range(16)]
    check(agree >= 80.0, f"K1-TC gear vs plain-decimator gear audio agreement {agree:.1f} dB")
    tc_s, plain_s = (sum(seconds[k]) / 2 for k in ("K1-TC", "plain"))
    first = order[0]
    rest = {k: seconds[k][1:] if k == first else seconds[k] for k in seconds}
    rest_ms = ", ".join(f"{k} {sum(v) / len(v) / n_blocks * 1e3:.3f} ms/block ({len(v)} runs)"
                        for k, v in rest.items())
    print(f"phase 5 bank: K1-TC path {tc_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
          f"{signal_s / tc_s:.2f}), plain-decimator path {plain_s / n_blocks * 1e3:.3f} "
          f"ms/block ({signal_s / plain_s:.2f}), mean of 2 runs each; without the first "
          f"timed run ({first}): {rest_ms}; K1-TC launches "
          f"{launches} in the last K1-TC run; tone SNR {snrs[0]:.2f} / {snrs[1]:.2f} dB "
          f"(demods {tone_demods}); audio agreement {agree:.2f} dB over the bank, "
          f"{min(per_channel):.2f} dB at the worst channel [{tag}]", flush=True)
    return launches, xs


#: phase 6: each receiver's device block (the engine's block solver at
#: 10 MS/s; PERF.md §4)
RECEIVER_BLOCKS = {"am": 10_240_000, "ssb": 20_480_000, "wfm": 10_240_000}


def phase_receivers(dev: torch.device, tag: str) -> None:
    """AM, SSB and WFM through RxPipeline on the card, each behind K1."""
    n_blocks, n_cpu = 6, 2
    for name in RECEIVERS:
        pipe, src = receiver_pipeline(name, dev)
        block = pipe.device_block
        check(block == RECEIVER_BLOCKS[name], f"{name}: device block {block}")
        check(pipe.fused_ingest, f"{name}: the i16 capture must go straight into K1")
        t0 = time.perf_counter()
        blocks = [testsource.to_iq_int16(testsource.generate(src, block, start_sample=b * block))
                  for b in range(n_blocks)]
        print(f"phase 6 {name}: generated {n_blocks} blocks of {block} i16 samples on the host "
              f"in {time.perf_counter() - t0:.2f} s (set-up, not timed); channel plan "
              f"{pipe.plans[0]} [{tag}]", flush=True)
        list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up of both paths
        with plain_decimator():
            list(pipe.run(lambda b, n: blocks[b], 2))

        signal_s = n_blocks * block / PRODUCT_RATE
        seconds = {"K1": [], "twin": []}
        for path in ("twin", "K1", "K1", "twin"):
            if path == "K1":
                flat_decimate.launches = flat_decimate_tc.launches = 0
                audio, elapsed = run_product(pipe, blocks)
                launches = flat_decimate.launches
                check(launches == n_blocks and flat_decimate_tc.launches == 0,
                      f"{name}: K1 launched {launches} times, K1-TC "
                      f"{flat_decimate_tc.launches}, for {n_blocks} blocks")
            else:
                with plain_decimator():
                    twin_audio, elapsed = run_product(pipe, blocks)
            seconds[path].append(elapsed)
            print(f"phase 6 {name} ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
                  f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
                  f"{signal_s / elapsed:.2f} [{tag}]", flush=True)

        per_block = pipe.demod_cfgs[0].resampler_plan.block_out
        check(audio.shape == (n_blocks * per_block,), f"{name}: audio shape {audio.shape}")
        check(bool(np.isfinite(audio).all()), f"{name}: non-finite audio")
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
        check(snr > 25.0, f"{name}: tone SNR {snr:.1f} dB")
        agree = agreement_db(twin_audio, audio)
        check(agree >= 80.0, f"{name}: K1 path vs twin path audio agreement {agree:.1f} dB")
        cpu_pipe, _ = receiver_pipeline(name, "cpu")
        t0 = time.perf_counter()
        cpu_audio = np.concatenate([o["channels"][0]["audio"] for _, o in cpu_pipe.run(
            lambda b, n: blocks[b], n_cpu)])
        cpu_s = time.perf_counter() - t0
        cpu_agree = agreement_db(cpu_audio, audio[:n_cpu * per_block])
        check(cpu_agree >= 80.0, f"{name}: card vs CPU pipeline agreement {cpu_agree:.1f} dB")
        k1_s, twin_s = (sum(seconds[k]) / 2 for k in ("K1", "twin"))
        print(f"phase 6 {name}: K1 path {k1_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
              f"{signal_s / k1_s:.2f}), twin path {twin_s / n_blocks * 1e3:.3f} ms/block "
              f"({signal_s / twin_s:.2f}), mean of 2 runs each; K1 launches {launches} "
              f"in the last K1 run; tone SNR {snr:.2f} dB; K1 vs twin {agree:.2f} dB; card vs "
              f"CPU pipeline on {n_cpu} blocks {cpu_agree:.2f} dB (CPU run {cpu_s:.1f} s) "
              f"[{tag}]", flush=True)


SERVER_BLOCKS = 6


def http(base: str, path: str, method: str = "GET", body: dict | None = None):
    """One request to the server: (status, JSON reply, or the raw bytes of a
    WAV)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read()
            return r.status, (raw if r.headers["Content-Type"] == "audio/wav" else json.loads(raw))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(pipe: RxPipeline, blocks: list[np.ndarray], tag: str) -> dict:
    """The REST server on the card, driven over HTTP, streaming and preloaded."""
    blocks = blocks[:SERVER_BLOCKS]
    check(len(blocks) == SERVER_BLOCKS, "phase 3 made too few blocks")
    # the reference: RxPipeline.run on the same blocks, its audio through the
    # WAV egress's int16 rounding
    ref = np.concatenate([o["channels"][0]["audio"] for _, o in pipe.run(
        lambda b, n: blocks[b], SERVER_BLOCKS)])
    ref_pcm = np.clip(ref * 32768.0, -32768, 32767).astype(np.int16)
    session = Session(device=DEVICE)
    srv = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "product.sdriq")
            t0 = time.perf_counter()
            writer = sdriq.SdriqWriter(path, sample_rate=int(PRODUCT_RATE))
            for b in blocks:
                writer.write(b)
            writer.close()
            print(f"phase 7 server: wrote {SERVER_BLOCKS} blocks of phase 3 to a .sdriq "
                  f"({os.path.getsize(path) / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s; "
                  f"server on {base} [{tag}]", flush=True)
            for i, preload in enumerate((False, True)):
                name = "preload" if preload else "streaming"
                code, reply = http(base, "/sdrangel/devicesets", "POST")
                check(code == 201 and reply["index"] == i, f"{name}: add device set {reply}")
                code, reply = http(base, f"/sdrangel/deviceset/{i}/device/settings", "PATCH", {
                    "kind": "filesource", "file_path": path, "log2_decim": 6,
                    "run_blocks": SERVER_BLOCKS, "publish_every": 1, "file_preload": preload})
                check(code == 200, f"{name}: device settings {reply}")
                code, reply = http(base, f"/sdrangel/deviceset/{i}/channel", "POST", {
                    "channelType": NFM, "inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})
                check(code == 201, f"{name}: add channel {reply}")
                flat_decimate.launches = flat_decimate_tc.launches = 0
                t0 = time.perf_counter()
                code, reply = http(base, f"/sdrangel/deviceset/{i}/device/run", "POST")
                check(code == 200, f"{name}: run {reply}")
                while http(base, f"/sdrangel/deviceset/{i}")[1]["state"] == "running":
                    check(time.perf_counter() - t0 < 300, f"{name}: still running after 300 s")
                    time.sleep(0.01)
                wall = time.perf_counter() - t0
                launches, tc_launches = flat_decimate.launches, flat_decimate_tc.launches
                _, summary = http(base, "/sdrangel")
                _, device = http(base, f"/sdrangel/deviceset/{i}/device/report")
                _, channel = http(base, f"/sdrangel/deviceset/{i}/channel/0/report")
                code, data = http(base, f"/sdrangel/deviceset/{i}/channel/0/audio")
                check(code == 200, f"{name}: audio {data}")
                with wave.open(io.BytesIO(data)) as w:
                    check(w.getframerate() == 48_000, f"{name}: WAV rate {w.getframerate()}")
                    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                entry = summary["devicesetlist"]["deviceSets"][i]
                check(entry["state"] == "idle" and not entry["error"],
                      f"{name}: /sdrangel reports {entry['state']} {entry['error']!r}")
                check(device["blocksProcessed"] == SERVER_BLOCKS,
                      f"{name}: {device['blocksProcessed']} blocks processed")
                check(launches == SERVER_BLOCKS and tc_launches == 0,
                      f"{name}: K1 launched {launches} times, K1-TC {tc_launches}, for "
                      f"{SERVER_BLOCKS} blocks")
                check(pcm.shape == ref_pcm.shape, f"{name}: audio {pcm.shape} vs {ref_pcm.shape}")
                snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float64) / 32768.0, 1000.0, 48_000.0)
                check(snr > 25.0, f"{name}: tone SNR {snr:.1f} dB")
                agree = agreement_db(ref_pcm, pcm)
                check(agree >= 80.0, f"{name}: server audio vs RxPipeline.run {agree:.1f} dB")
                runs[name] = {"pcm": pcm, "launches": launches,
                              "ms_per_block": device["elapsedSeconds"] / SERVER_BLOCKS * 1e3,
                              "rtf": device["realtimeFactor"]}
                print(f"phase 7 server ({name}): {SERVER_BLOCKS} blocks of {pipe.device_block} "
                      f"i16 samples, {runs[name]['ms_per_block']:.3f} ms/block from the first "
                      f"queued block to the last publish (device report elapsedSeconds "
                      f"{device['elapsedSeconds']:.4f} s), real-time factor {device['realtimeFactor']:.2f}"
                      f"; POST run to idle {wall:.3f} s host clock; K1 launches {launches}, "
                      f"K1-TC {tc_launches}; channel power {channel['channelPowerDB']:.2f} dB, "
                      f"squelch {channel['squelch']}, {channel['audioSamples']} audio samples; "
                      f"tone SNR {snr:.2f} dB; vs RxPipeline.run {agree:.2f} dB [{tag}]",
                      flush=True)
            # the streaming run's feed alone: memmap read, copy, pin, H2D
            _, mm = sdriq.open_mmap(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(SERVER_BLOCKS):
                pipe.upload(sdriq.read_block(mm, b * pipe.device_block, pipe.device_block))
            torch.cuda.synchronize()
            feed_ms = (time.perf_counter() - t0) / SERVER_BLOCKS * 1e3
            del mm
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    equal = np.array_equal(runs["streaming"]["pcm"], runs["preload"]["pcm"])
    check(equal, "preload audio differs from streaming audio")
    print(f"phase 7 server: preload audio equals streaming audio bit for bit ({equal}); "
          f"streaming {runs['streaming']['ms_per_block']:.3f} ms/block (RTF "
          f"{runs['streaming']['rtf']:.2f}), preload without per-block H2D "
          f"{runs['preload']['ms_per_block']:.3f} ms/block (RTF {runs['preload']['rtf']:.2f}); "
          f"the streaming feed alone (memmap read, copy, pin, H2D; synchronized) "
          f"{feed_ms:.3f} ms/block [{tag}]", flush=True)
    return {name: r["launches"] for name, r in runs.items()}


def tone_af(tones: tuple[float, ...]):
    """af_source(b, c, count): channel c's continuous full-scale tone, the
    AF the Tx session and the `mod` CLI make."""
    def src(b, c, count):
        tt = (b * count + np.arange(count)) / 48_000.0
        return np.sin(2 * np.pi * tones[c] * tt).astype(np.float32)
    return src


def int16_agreement(want: np.ndarray, got: np.ndarray) -> tuple[int, float]:
    """(max |difference| in LSB, agreement in dB) of two int16 captures."""
    return (int(np.abs(got.astype(np.int32) - want).max()),
            agreement_db(want.astype(np.float64), got.astype(np.float64)))


def tx_stage_ms(pipe: TxPipeline, af: torch.Tensor) -> dict:
    """Each stage of one Tx block alone, device ms by CUDA events: the AF
    upload, modulate, UpChannelizer, ×2^k cascade, int16, read-back."""
    state = pipe.init_state()
    group = pipe.groups[0]
    host_af = [af[c].cpu().numpy() for c in range(af.shape[0])]
    _, iq = group.modulate(state["mod"][0], af, group.cfg, pipe._residuals[0])
    _, bb = interp.upchannelize_bank(state["up"][0], iq, group.signs)
    merged = bb.sum(dim=0)
    _, out = interp.interpolate_cascade(state["dev"], merged, pipe.sink.log2_interp)
    i16 = (torch.view_as_real(out) * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)
    return {
        "upload": time_ms(lambda: pipe.upload(host_af)),
        "modulate": time_ms(lambda: group.modulate(state["mod"][0], af, group.cfg,
                                                   pipe._residuals[0])),
        "upchannelize": time_ms(lambda: interp.upchannelize_bank(state["up"][0], iq,
                                                                 group.signs)),
        "cascade": time_ms(lambda: interp.interpolate_cascade(state["dev"], merged,
                                                              pipe.sink.log2_interp)),
        "int16": time_ms(lambda: (torch.view_as_real(out) * 32768.0).clamp(
            -32768.0, 32767.0).to(torch.int16)),
        "read-back": time_ms(lambda: fetch(i16)),
        "step": time_ms(lambda: pipe.step(state, af)),
    }


def tx_host_ms(pipe: TxPipeline, af, iters: int = 10) -> dict:
    """The host's part of one Tx block, each piece alone on the host clock
    (mean of `iters`, synchronized before and after): the AF tone, the
    upload (stack, pin, H2D), enqueueing the step (no wait), the read-back
    (a pinned buffer, D2H, the wait) and a pinned allocation of the
    read-back's size alone."""
    state = pipe.init_state()
    host_af = [af(0, c, 4096) for c in range(len(pipe.specs))]
    dev_af = pipe.upload(host_af)
    _, out = pipe.step(state, dev_af)

    def clock(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def enqueue() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.step(state, dev_af)
        spent = time.perf_counter() - t0
        torch.cuda.synchronize()
        return spent * 1e3

    enqueue()
    return {
        "af": clock(lambda: [af(0, c, 4096) for c in range(len(pipe.specs))]),
        "upload": clock(lambda: pipe.upload(host_af)),
        "step enqueue": sum(enqueue() for _ in range(iters)) / iters,
        "read-back": clock(lambda: fetch(out)),
        "pinned alloc": clock(lambda: torch.empty(out.shape, dtype=out.dtype, pin_memory=True)),
    }


def phase_tx(dev: torch.device, tag: str) -> int:
    """The Tx path on the card: full width, loopback through K1, four
    channels, the CLI, a Tx device set over HTTP."""
    af = tone_af((1000.0,))
    spec = [TxChannelSpec(NFM_MOD, 20_000.0, {})]
    pipe = TxPipeline(TxDeviceConfig(TX_RATE, 6), spec, device=dev)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 flags on after TxPipeline construction")
    check(pipe.device_block == TX_BLOCK and pipe.plans[0].signs == (),
          f"Tx device block {pipe.device_block}, plan {pipe.plans[0]}")
    list(pipe.run(af, 4))  # warm-up by block count: cuFFT plans, cuDNN choices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(pipe.run(af, TX_BLOCKS))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tx = np.concatenate(blocks)
    check(tx.shape == (TX_BLOCKS * TX_BLOCK, 2) and tx.dtype == np.int16,
          f"Tx output {tx.shape} {tx.dtype}")
    block_s = 4096 / 48_000.0
    stages = tx_stage_ms(pipe, pipe.upload([af(0, 0, 4096)]))
    host = tx_host_ms(pipe, af)
    t0 = time.perf_counter()
    cpu = np.concatenate(list(TxPipeline(TxDeviceConfig(TX_RATE, 6), spec, device="cpu").run(af, 2)))
    cpu_s = time.perf_counter() - t0
    lsb, agree = int16_agreement(cpu, tx[:len(cpu)])
    check(lsb <= 1 and agree >= 80.0, f"Tx card vs CPU: {lsb} LSB, {agree:.1f} dB")
    print(f"phase 8a tx: 9.6 MS/s x64 NFM +20 kHz, {TX_BLOCKS} blocks of {TX_BLOCK} int16 I/Q "
          f"({len(tx)} samples) in {elapsed:.4f} s = {elapsed / TX_BLOCKS * 1e3:.3f} ms/block "
          f"(host clock, read-back included, after 4 warm-up blocks), Tx real-time factor "
          f"{TX_BLOCKS * block_s / elapsed:.2f}; stages alone, device ms by CUDA events: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + "; host ms alone: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
          + f"; card vs CPU on 2 blocks: max {lsb} LSB, {agree:.2f} dB (CPU run {cpu_s:.1f} s) "
          f"[{tag}]", flush=True)
    print(f"phase 8a tx: device time of 8 blocks by torch.profiler, against the timed run's "
          f"{elapsed / TX_BLOCKS * 1e3:.3f} ms/block [{tag}]", flush=True)
    _device_time(lambda: list(pipe.run(af, 8)), 8, elapsed / TX_BLOCKS * 8)

    # (b) the loopback through the port's Rx path, K1 in front
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tx.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(TX_RATE))
        for b in blocks:
            writer.write(b)
        writer.close()
        info, mm = sdriq.open_mmap(path)
        check(info.n_samples == len(tx) and info.sample_rate == int(TX_RATE),
              f"loopback capture header {info}")
        rx = RxPipeline(DeviceConfig(TX_RATE, log2_decim=6),
                        [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
        check(rx.device_block == TX_RX_BLOCK, f"Rx block {rx.device_block}")
        n_rx = 3
        check(n_rx * TX_RX_BLOCK <= info.n_samples, "loopback capture too short")
        flat_decimate.launches = flat_decimate_tc.launches = 0
        t0 = time.perf_counter()
        audio = np.concatenate([o["channels"][0]["audio"] for _, o in rx.run(
            lambda b, count: sdriq.read_block(mm, b * count, count), n_rx)])
        rx_s = time.perf_counter() - t0
        loop_launches, tc = flat_decimate.launches, flat_decimate_tc.launches
        del mm
    check(loop_launches == n_rx and tc == 0,
          f"loopback: K1 launched {loop_launches} times, K1-TC {tc}, for {n_rx} Rx blocks")
    check(bool(np.isfinite(audio).all()), "loopback: non-finite audio")
    snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"loopback tone SNR {snr:.1f} dB")
    print(f"phase 8b tx loopback: the {TX_BLOCKS} blocks as a .sdriq, decoded by RxPipeline on "
          f"cuda at 9.6 MS/s /64 NFM +20 kHz over {n_rx} blocks of {TX_RX_BLOCK} in {rx_s:.2f} s; "
          f"K1 launches {loop_launches}, K1-TC {tc}; {len(audio)} audio samples, tone SNR "
          f"{snr:.2f} dB [{tag}]", flush=True)

    # (c) four channels in three groups, merged by sum/÷n
    four = [TxChannelSpec(NFM_MOD, -50_000.0, {}), TxChannelSpec(NFM_MOD, 50_000.0, {}),
            TxChannelSpec("sdrangel.channeltx.modam", 20_000.0, {}),
            TxChannelSpec("sdrangel.channeltx.modssb", -20_000.0, {})]
    src4 = tone_af((700.0, 1100.0, 900.0, 1300.0))
    card4, cpu4 = (np.concatenate(list(TxPipeline(TxDeviceConfig(TX_RATE, 6), four,
                                                  device=device).run(src4, 2)))
                   for device in (dev, "cpu"))
    groups4 = [len(g.idxs) for g in TxPipeline(TxDeviceConfig(TX_RATE, 6), four,
                                               device=dev).groups]
    check(groups4 == [2, 1, 1], f"four channels: groups {groups4}")
    lsb4, agree4 = int16_agreement(cpu4, card4)
    check(lsb4 <= 1 and agree4 >= 80.0, f"four channels: card vs CPU {lsb4} LSB, {agree4:.1f} dB")
    x = card4[TX_BLOCK:].astype(np.float32)
    c = (x[:, 0] + 1j * x[:, 1])[::64]  # the 150 kHz baseband's samples (in-band)
    spec4 = np.abs(np.fft.fft(c * np.hanning(len(c))))
    freqs = np.fft.fftfreq(len(c), 64 / TX_RATE)
    peaks = [float(spec4[np.abs(freqs - f0) < 6_000.0].max() / np.median(spec4))
             for f0 in (-50e3, 50e3, 20e3, -19e3)]
    check(min(peaks) > 50.0, f"four channels: carrier peaks over the median {peaks}")
    print(f"phase 8c tx four channels: NFM -50/+50 kHz, AM +20 kHz, SSB -20 kHz in groups "
          f"{groups4}, 2 blocks: card vs CPU max {lsb4} LSB, "
          f"{agree4:.2f} dB; each carrier {min(peaks):.0f}x or more above the median bin [{tag}]",
          flush=True)

    # (d) the CLI: 384 kS/s ×1, two UpChannelizer stages
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.sdriq")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdrangel_tpu_torch", "mod", "--device", DEVICE,
             "--channel", "nfm:20000", "--rate", "384000", "--seconds", "1.0", "--out", out],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"mod CLI exit {proc.returncode}:\n{proc.stderr}")
        info, mm = sdriq.open_mmap(out)
        cli = np.array(mm)
        del mm
    ref_pipe = TxPipeline(TxDeviceConfig(384_000.0), [TxChannelSpec(NFM_MOD, 20_000.0, {})],
                          device=dev)
    check(ref_pipe.plans[0].signs == (0, 0), f"CLI plan {ref_pipe.plans[0]}")
    ref = np.concatenate(list(ref_pipe.run(tone_af((1000.0,)), 11)))
    check(info.sample_rate == 384_000 and cli.shape == ref.shape, f"CLI capture {cli.shape}")
    lsb_cli, agree_cli = int16_agreement(ref, cli)
    check(lsb_cli <= 1 and agree_cli >= 80.0, f"CLI vs TxPipeline {lsb_cli} LSB")
    print(f"phase 8d tx cli: mod --device cuda 384 kS/s x1 nfm:20000 (stages {ref_pipe.plans[0].signs}) "
          f"exit 0 in {cli_s:.2f} s (process start included), {len(cli)} samples; against "
          f"TxPipeline in this process max {lsb_cli} LSB, {agree_cli:.2f} dB [{tag}]", flush=True)
    print("phase 8d tx cli stderr: " + proc.stderr.strip().replace("\n", " | "), flush=True)

    # (e) a Tx device set over HTTP
    n_set = 20
    session = Session(device=DEVICE)
    srv = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "set.sdriq")
            code, reply = http(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
            check(code == 201 and reply["direction"] == "tx", f"add Tx set {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "file_path": path, "sample_rate": TX_RATE, "log2_interp": 6})
            check(code == 200, f"sink settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": NFM_MOD, "inputFrequencyOffset": 20_000.0,
                "toneFrequency": 1000.0})
            check(code == 201, f"add modulator {reply}")
            t0 = time.perf_counter()
            code, reply = http(base, "/sdrangel/deviceset/0/device/run", "POST")
            check(code == 200, f"run {reply}")
            while http(base, "/sdrangel/deviceset/0/device/report")[1]["blocksProcessed"] < n_set:
                check(time.perf_counter() - t0 < 300, "Tx set: 20 blocks not reached in 300 s")
                time.sleep(0.005)
            _, report = http(base, "/sdrangel/deviceset/0/device/report")
            code, _ = http(base, "/sdrangel/deviceset/0/device/run", "DELETE")
            wall = time.perf_counter() - t0
            check(code == 200, "stop the Tx set")
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"],
                  f"Tx set {entry['state']} {entry['error']!r}")
            info, mm = sdriq.open_mmap(path)
            recorded = np.array(mm[:n_set * TX_BLOCK])
            del mm
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    final = session.device_sets[0].blocks_processed
    check(info.sample_rate == int(TX_RATE) and info.n_samples == final * TX_BLOCK
          and final >= n_set, f"Tx set capture {info}, {final} blocks")
    equal = np.array_equal(recorded, tx[:n_set * TX_BLOCK])
    check(equal, "the Tx set's samples differ from phase 8a's first 20 blocks")
    print(f"phase 8e tx server: a Tx set over HTTP (NFM +20 kHz, 9.6 MS/s x64, filesink) stopped "
          f"after {report['blocksProcessed']} blocks ({final} recorded, {info.n_samples} samples); "
          f"its first {n_set} blocks equal phase 8a's ({equal}); device report at the stop: "
          f"realtimeFactor {report['realtimeFactor']:.2f}, elapsedSeconds "
          f"{report['elapsedSeconds']:.4f} ({report['elapsedSeconds'] / report['blocksProcessed'] * 1e3:.3f} "
          f"ms/block); POST run to stop {wall:.3f} s host clock [{tag}]", flush=True)
    return loop_launches


# -- phase 9: NFM CTCSS and the AF squelch, sync AM, broadcast FM; K-PLL ------

AM = "sdrangel.channel.amdemod"
BFM = "sdrangel.channel.bfm"
SLICE_BLOCK = 10_240_000  # the device block of sync AM (÷64) and BFM (÷32) at 10 MS/s
KPLL_CHANNELS, KPLL_SHORT, KPLL_LONG = 16, 4096, 49_152  # 49,152: one audio block
KPLL_ENTRIES = ("pll_run", "ref_pll_run", "pilot_pll_run")  # pll_scan's wrappers
#: each entry's serial kernel, whose hot loop bounds it
KPLL_SERIAL = {"pll_run": "pll_chain_kernel", "ref_pll_run": "ref_pll_kernel",
               "pilot_pll_run": "pilot_pll_kernel"}
#: every kernel of pll_scan.cu: pll_run's three, then the other two entries'
KPLL_KERNELS = ("pll_detect_kernel", "pll_chain_kernel", "pll_carrier_kernel",
                "ref_pll_kernel", "pilot_pll_kernel")
KPLL_SOURCE = os.path.join(REPO, "sdrangel_tpu_torch", "kernels", "csrc", "pll_scan.cu")
#: operations per step, counting each add, multiply, divide, compare-select
#: and each transcendental (sincos, atan2) as one: a floor for the bound
KPLL_OPS = {"pll_run": 15, "ref_pll_run": 22, "pilot_pll_run": 24}
#: the lock level of BFM's pilot: half the 10 % pilot's analytic magnitude
#: (0.1 of the 75 kHz deviation, the demod's unit)
PILOT_LOCK_LEVEL = 0.05
DEP_LATENCY = 4  # cycles between dependent fixed-latency instructions (CC 7.0+)


def reset_counts() -> None:
    flat_decimate.launches = flat_decimate_tc.launches = 0
    for name in KPLL_ENTRIES:
        getattr(pll_scan, name).launches = 0


def kpll_launches() -> int:
    return sum(getattr(pll_scan, name).launches for name in KPLL_ENTRIES)


def _sass_kernel(sass: str, kernel: str) -> list[tuple[int, str]]:
    """(address, instruction) of one kernel in cuobjdump -sass output."""
    out, on = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            on = kernel in line
        elif on and (m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)):
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def _sass_regs(op: str) -> list[str]:
    """The registers an operand reads or names (Rn.64 is Rn and Rn+1; an
    address [Rn.64+x] reads its base)."""
    op = op.replace("|", "").replace(".reuse", "").strip().lstrip("-!~")
    if m := re.fullmatch(r"(U?R)(\d+)((?:\.\w+)*)", op):
        regs = [f"{m.group(1)}{m.group(2)}"]
        if ".64" in m.group(3):
            regs.append(f"{m.group(1)}{int(m.group(2)) + 1}")
        return regs
    if re.fullmatch(r"U?P\d", op):
        return [op]
    if m := re.search(r"\[(U?R\d+)", op):
        return [m.group(1)]
    return []


def sass_chain_cycles(sass: str, kernel: str, unroll: int) -> tuple[float, int]:
    """The critical path of one step of a K-PLL kernel, in cycles, read from
    its SASS. The hot loop (the widest backward branch; `unroll` steps) is
    walked in address order keeping each register's ready time: DEP_LATENCY
    cycles per dependent instruction (the floor of Hopper's fixed-latency
    pipes; MUFU, conversions and FRND take longer), loads, moves and
    constants ready at once. A path through the slow paths of the math
    (a call, local memory, an inner loop: sincosf's large-argument
    reduction, fmodf's long division, the division's slow path) is
    dropped; where the other paths merge, the later ready time is kept, so
    the special-value shortcuts (a zero or an infinite argument) do not
    shorten it. Returns (the loop-carried registers' latest ready time ÷
    unroll, instructions in the loop)."""
    ins = _sass_kernel(sass, kernel)
    target = lambda text: int(re.search(r"0x([0-9a-f]+)\s*$", text).group(1), 16)
    back = [(a, target(t)) for a, t in ins if re.search(r"\bBRA\b", t) and target(t) < a]
    end, head = max(back, key=lambda b: b[0] - b[1])
    inner = [(t, a) for a, t in back if head < t and a < end]
    slow = lambda a, text: (any(lo <= a <= hi for lo, hi in inner)
                            or re.match(r"(@!?U?P\d\s+)?(CALL|LDL|STL)\b", text))
    free = ("LDG", "LDC", "ULDC", "S2R", "S2UR", "CS2R", "MOV", "UMOV")
    no_data = ("BSSY", "BSYNC", "NOP", "EXIT", "RET", "WARPSYNC", "STG", "STS")
    pending, state, written, live_in, count = {}, {}, set(), set(), 0
    for a, text in ins:
        if not head <= a <= end:
            continue
        incoming = ([state] if state is not None else []) + pending.pop(a, [])
        if not incoming or slow(a, text):
            state = None  # unreachable, or a slow path: this path ends here
            continue
        state = {r: max(st.get(r, 0) for st in incoming) for r in set().union(*incoming)}
        guard = None
        if m := re.match(r"@!?(U?P\d)\s+(.*)", text):
            guard, text = m.group(1), m.group(2)
        opcode, _, rest = text.partition(" ")
        ops = [o for o in rest.split(",") if o.strip()]
        base = opcode.split(".")[0]
        if base == "BRA":
            if a == end:
                break
            if a < target(text) <= end:
                pending.setdefault(target(text), []).append(dict(state))
            if guard is None and len(ops) <= 1:
                state = None
            continue
        if base in no_data:
            continue
        count += 1
        dests, i = [], 0
        while i < len(ops) and re.fullmatch(r"\s*U?P(\d|T)\s*", ops[i]):
            dests.append(ops[i].strip())
            i += 1
        pred_only = "SETP" in opcode or base == "FCHK"  # they write predicates only
        if i < len(ops) and not pred_only and "[" not in ops[i] and _sass_regs(ops[i]):
            dests += _sass_regs(ops[i])
            i += 1
            while i < len(ops) and re.fullmatch(r"\s*U?P\d\s*", ops[i]):
                dests.append(ops[i].strip())
                i += 1
        srcs = [r for o in ops[i:] for r in _sass_regs(o)] + ([guard] if guard else [])
        live_in.update(r for r in srcs if r not in written)
        written.update(dests)
        ready = max([state.get(r, 0) for r in srcs] or [0])
        ready += 0 if (base in free or opcode.startswith("IMAD.MOV")) else DEP_LATENCY
        for d in dests:
            if d not in ("RZ", "PT", "URZ", "UPT"):
                state[d] = max(state.get(d, 0), ready) if guard else ready
    check(state is not None, f"{kernel}: every path through its hot loop is a slow one")
    carried = max((state.get(r, 0) for r in live_in & written), default=0)
    return carried / unroll, count


def kpll_unroll() -> dict:
    """Steps per pass of each entry's hot loop, read from the source:
    pll_chain_kernel's kChainUnroll, walk()'s kUnroll for the others."""
    with open(KPLL_SOURCE) as f:
        src = f.read()
    unroll, chain = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                     for k in ("kUnroll", "kChainUnroll"))
    return {name: chain if name == "pll_run" else unroll for name in KPLL_ENTRIES}


def kpll_sass(so_path: str) -> dict:
    """Each K-PLL entry's per-step critical path from cuobjdump -sass of its
    serial kernel in the built library: name -> (cycles per step,
    instructions in its loop)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    unroll = kpll_unroll()
    return {name: sass_chain_cycles(sass, f"{len(kernel)}{kernel}", unroll[name])
            for name, kernel in KPLL_SERIAL.items()}


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.strip().splitlines()[torch.cuda.current_device()])


def pll_input(rng, channels: int, size: int, real: bool) -> np.ndarray:
    """AM carriers a few Hz off at 48 kHz (80 % depth, noise), or a 192 kHz
    MPX with a 10 % 19 kHz pilot, one row per channel."""
    if real:
        tt = np.arange(size) / 192_000.0
        phi = rng.uniform(-np.pi, np.pi, (channels, 1))
        x = (0.1 * np.cos(2 * np.pi * 19_000.0 * tt + phi) + 0.4 * np.sin(2 * np.pi * 1e3 * tt)
             + 0.01 * rng.standard_normal((channels, size)))
        return x.astype(np.float32)
    tt = np.arange(size) / 48_000.0
    f = rng.uniform(-40.0, 40.0, (channels, 1))
    phi = rng.uniform(-np.pi, np.pi, (channels, 1))
    x = (1 + 0.8 * np.sin(2 * np.pi * 1e3 * tt)) * np.exp(1j * (2 * np.pi * f * tt + phi))
    x = x + 0.05 * (rng.standard_normal((channels, size)) + 1j * rng.standard_normal(
        (channels, size)))
    return x.astype(np.complex64)


def gated(x: np.ndarray) -> np.ndarray:
    """x (C, T) with a leading run of exact zeros, a zeroed stretch mid-block
    and single zeros of each sign: the input where pll_run's split detector
    must fall back to the rotated product's."""
    x = x.copy()
    x[:, :37] = 0.0
    x[:, x.shape[1] // 2:x.shape[1] // 2 + 100] = 0.0
    x[0, 3001 % x.shape[1]] = complex(-0.0, 0.0)
    x[:, -596] = complex(-0.0, -0.0)
    return x


def kernel_device_ms(fn, calls: int = 5) -> dict:
    """Device time per launch of each kernel fn() launches, by torch.profiler
    (CUPTI; a kernel launched through ctypes shows under its own name). The
    mean is over the launches the trace holds: late in a long process it
    has held fewer than were made."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.count}


def _wrap(a) -> np.ndarray:
    return np.angle(np.exp(1j * np.asarray(a, np.float64)))


#: entry point -> (plain loop, its arguments, state maker, real input)
KPLL = {
    "pll_run": (phaselock.pll_plain, phaselock.pll_gains(48_000.0), phaselock.make_pll, False),
    "ref_pll_run": (phaselock.ref_pll_plain, (phaselock.ref_pll_coeffs(),),
                    phaselock.make_ref_pll, False),
    "pilot_pll_run": (phaselock.pilot_pll_plain,
                      (phaselock.pilot_pll_coeffs(19_000.0, 192_000.0),),
                      lambda dev, shape: phaselock.make_pilot_pll(19_000.0, 192_000.0, dev,
                                                                  shape), True),
}


def kpll_bound(name: str, channels: int, size: int) -> tuple[float, str]:
    """(ms, what bounds it): the input read and the output written once over
    HBM against KPLL_OPS per step over the FP32 peak."""
    per = 4 if name == "pilot_pll_run" else 8
    t_bytes = channels * size * 2 * per / HBM_BPS
    t_ops = channels * size * KPLL_OPS[name] / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def phase_kpll(dev: torch.device, tag: str, sass: dict, clock_mhz: float) -> dict:
    """K-PLL against its plain loop, timed beside its bound and latency bound."""
    rng = np.random.default_rng(909)
    cpu = torch.device("cpu")
    out = {}
    for name, (plain, args, make, real) in KPLL.items():
        wrapper = getattr(pll_scan, name)
        err = {}
        for size, plain_dev in ((KPLL_SHORT, dev), (KPLL_LONG, cpu)):
            if size == KPLL_LONG and real:
                continue  # the pilot loop: 16 × 4,096 on the card only
            x = pll_input(rng, KPLL_CHANNELS, size, real)
            if name == "pll_run" and size == KPLL_SHORT:
                x = gated(x)
            state0 = torch.stack(list(make(cpu, (KPLL_CHANNELS,))))
            st_k = state0.to(dev, copy=True)  # the kernel updates it in place
            y_k = wrapper(torch.from_numpy(x).to(dev), st_k, *args)
            torch.cuda.synchronize()
            y_p, st_p = plain(torch.from_numpy(x).to(plain_dev), state0.to(plain_dev), *args)
            y_k, st_k, y_p, st_p = (v.cpu().numpy() for v in (y_k, st_k, y_p, st_p))
            if plain_dev.type == "cuda":
                check(np.array_equal(y_k, y_p) and np.array_equal(st_k, st_p),
                      f"{name} at {size}: not bit-equal to its plain loop on the card")
            if real:  # pre-update phases in [0, 2π)
                e = float(np.abs(_wrap(y_k - y_p)).max())
                end = float(np.abs(_wrap(st_k[0] - st_p[0])).max())
                check(e <= 2e-3 and end <= 2e-3, f"{name}: phases {e:.2e}, end {end:.2e} rad")
                db = None
            else:
                e = float(np.abs(y_k - y_p).max())
                db = agreement_db(y_p.view(np.float32), y_k.view(np.float32))
                phase_row = 3 if name == "ref_pll_run" else 0
                end = float(np.abs(_wrap(st_k[phase_row] - st_p[phase_row])).max())
                limit = (1e-4, 1e-4) if size == KPLL_SHORT else (1e-3, 1e-3)
                check(e <= limit[0] and end <= limit[1],
                      f"{name} at {size}: carrier {e:.2e}, end phase {end:.2e} rad")
            err[size] = (e, db, end)
            print(f"phase 9a k-pll {name} {KPLL_CHANNELS}x{size} vs plain on {plain_dev.type}: "
                  f"max abs {e:.3e}" + (f", {db:.2f} dB over the block" if db else "")
                  + f", end phase {end:.3e} rad [{tag}]", flush=True)
        x_long = torch.from_numpy(pll_input(rng, KPLL_CHANNELS, KPLL_LONG, real)).to(dev)
        st = torch.stack(list(make(dev, (KPLL_CHANNELS,)))).contiguous()
        ms16 = time_ms(lambda: wrapper(x_long, st, *args))
        x_one = x_long[:1].contiguous()
        st1 = st[:, :1].contiguous()
        ms1 = time_ms(lambda: wrapper(x_one, st1, *args))
        # the plain loop (~20 launches a sample): pll_run's at the main
        # path's shape, the others' over the first 4,096 samples
        plain_size = KPLL_LONG if name == "pll_run" else KPLL_SHORT
        x_plain = x_one[:, :plain_size].contiguous()
        plain_ms = time_ms(lambda: plain(x_plain, st1, *args), iters=1, warmup=0)
        cycles, n_ins = sass[name]
        latency_ms = KPLL_LONG * cycles / (clock_mhz * 1e3)
        bound_ms, bound_by = kpll_bound(name, 1, KPLL_LONG)
        # each kernel of the call alone, by the profiler: pll_run's three
        split = {}
        for shape, (xs, sts) in (("1ch", (x_one, st1)), ("16ch", (x_long, st))):
            by_name = kernel_device_ms(lambda: wrapper(xs, sts, *args))
            for k in KPLL_KERNELS:  # no name is a part of another
                if found := [v for key, v in by_name.items() if k in key]:
                    split[f"{k}_ms_{shape}"] = sum(found)
        serial_ms = split.get(f"{KPLL_SERIAL[name]}_ms_1ch")
        out[name] = {"ms": ms1, "ms_16ch": ms16, "plain_ms": plain_ms, "kernel_ms": split,
                     "plain_samples": plain_size, "bound_ms": bound_ms,
                     "bound_by": bound_by, "latency_bound_ms": latency_ms,
                     "chain_cycles_per_step": cycles, "loop_instructions": n_ins,
                     "cycles_per_step": ms1 * clock_mhz * 1e3 / KPLL_LONG,
                     "max_abs_err": max(v[0] for v in err.values()), "errors": err}
        print(f"phase 9a k-pll {name} time: 1x{KPLL_LONG} (the main path's shape) "
              f"{ms1:.4f} ms, {KPLL_CHANNELS}x{KPLL_LONG} {ms16:.4f} ms (CUDA events, 20 "
              f"launches after 3 warm-up); plain loop on the card 1x{plain_size} {plain_ms:.1f} "
              f"ms (one call); bound {bound_ms:.6f} ms by {bound_by}; latency bound from the "
              f"SASS {cycles:.1f} cycles per step ({n_ins} instructions in the "
              f"{kpll_unroll()[name]}-step loop of {KPLL_SERIAL[name]}) = {latency_ms:.4f} ms "
              f"at {clock_mhz:.0f} MHz; measured {out[name]['cycles_per_step']:.1f} cycles per "
              f"step, the latency bound {100 * latency_ms / ms1:.1f} % of the measured time; "
              "each kernel alone (torch.profiler, ms per launch): "
              + (", ".join(f"{k} {v:.4f}" for k, v in split.items()) or "not measured")
              + (f"; the latency bound {100 * latency_ms / serial_ms:.1f} % of "
                 f"{KPLL_SERIAL[name]}'s time" if serial_ms else "") + f" [{tag}]", flush=True)
    return out


def _sync_am_pipe(dev, settings: dict) -> RxPipeline:
    return RxPipeline(DeviceConfig(PRODUCT_RATE, log2_decim=6),
                      [ChannelSpec(AM, 20_000.0, {"sync_am": True, **settings})], dev)


def phase_sync_am(dev: torch.device, tag: str) -> dict:
    """Sync AM on the product path, K1 and K-PLL once per block."""
    n_blocks, n_cpu = 6, 2
    src = testsource.TestSourceConfig(sample_rate=PRODUCT_RATE, modulation="am", am_depth=0.8,
                                      carrier_freq=20_000.0, amplitude=0.4)
    t0 = time.perf_counter()
    blocks = [testsource.to_iq_int16(testsource.generate(src, SLICE_BLOCK,
                                                         start_sample=b * SLICE_BLOCK))
              for b in range(n_blocks)]
    print(f"phase 9b sync am: generated {n_blocks} blocks of {SLICE_BLOCK} i16 samples in "
          f"{time.perf_counter() - t0:.2f} s (set-up, not timed) [{tag}]", flush=True)
    out = {}
    for mode, settings in (("usb", {}), ("dsb", {"sync_dsb": True})):
        pipe = _sync_am_pipe(dev, settings)
        check(pipe.device_block == SLICE_BLOCK and pipe.fused_ingest,
              f"sync am: device block {pipe.device_block}")
        list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up: cuFFT plans, the library
        reset_counts()
        audio, elapsed = run_product(pipe, blocks)
        k1, kp, pll = flat_decimate.launches, kpll_launches(), pll_scan.pll_run.launches
        per_entry = {name: getattr(pll_scan, name).launches for name in KPLL_ENTRIES}
        check(k1 == n_blocks and pll == n_blocks and kp == n_blocks,
              f"sync am {mode}: K1 {k1}, K-PLL {kp} (pll_run {pll}) launches for {n_blocks} blocks")
        per_block = pipe.demod_cfgs[0].resampler_plan.block_out
        check(audio.shape == (n_blocks * per_block,) and bool(np.isfinite(audio).all()),
              f"sync am {mode}: audio {audio.shape}")
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
        check(snr > 25.0, f"sync am {mode}: tone SNR {snr:.1f} dB")
        t0 = time.perf_counter()
        cpu_audio = np.concatenate([o["channels"][0]["audio"] for _, o in _sync_am_pipe(
            "cpu", settings).run(lambda b, n: blocks[b], n_cpu)])
        cpu_s = time.perf_counter() - t0
        agree = agreement_db(cpu_audio, audio[:n_cpu * per_block])
        check(agree >= 80.0, f"sync am {mode}: card vs CPU pipeline {agree:.1f} dB")
        signal_s = n_blocks * SLICE_BLOCK / PRODUCT_RATE
        out[mode] = {"k1": k1, "kpll": kp, "per_entry": per_entry,
                     "ms_per_block": elapsed / n_blocks * 1e3,
                     "rtf": signal_s / elapsed, "snr": snr, "cpu_db": agree}
        print(f"phase 9b sync am {mode}: 10 MS/s /64 AM +20 kHz, {n_blocks} blocks in "
              f"{elapsed:.4f} s = {elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
              f"{signal_s / elapsed:.2f}; K1 launches {k1}, K-PLL {kp} ("
              + ", ".join(f"{k} {v}" for k, v in out[mode]["per_entry"].items())
              + f"); tone SNR {snr:.2f} dB; "
              f"card vs CPU pipeline on {n_cpu} blocks {agree:.2f} dB (CPU run {cpu_s:.1f} s) "
              f"[{tag}]", flush=True)
    return out


def phase_ctcss(dev: torch.device, tag: str) -> int:
    """NFM with CTCSS and the AF squelch on a Tx NFM capture carrying 88.5 Hz."""
    n_rx = 3
    n_tx = -(-n_rx * TX_RX_BLOCK // TX_BLOCK)
    tx = TxPipeline(TxDeviceConfig(TX_RATE, 6), [TxChannelSpec(
        NFM_MOD, 20_000.0, {"ctcss_on": True, "ctcss_freq": 88.5})], device=dev)
    t0 = time.perf_counter()
    capture = np.concatenate(list(tx.run(tone_af((1000.0,)), n_tx)))

    def noisy(b: int, count: int) -> np.ndarray:  # 300 LSB rms, seeded per block
        g = np.random.default_rng(919 + b).standard_normal((count, 2), dtype=np.float32)
        return np.clip(capture[b * count:(b + 1) * count] + 300.0 * g, -32768, 32767
                       ).astype(np.int16)

    blocks = [noisy(b, TX_RX_BLOCK) for b in range(n_rx)]  # made before the timed run
    print(f"phase 9c ctcss: {n_tx} Tx blocks (NFM +20 kHz, CTCSS 88.5 Hz) with noise of 300 "
          f"LSB rms added, in {time.perf_counter() - t0:.2f} s (set-up) [{tag}]", flush=True)
    chans = [ChannelSpec(NFM, 20_000.0, {"ctcss_on": True, "ctcss_index": 8, "squelch_db": -60.0}),
             ChannelSpec(NFM, 20_000.0, {"ctcss_on": True, "ctcss_index": 9, "squelch_db": -60.0}),
             ChannelSpec(NFM, 20_000.0, {"delta_squelch": True, "squelch_db": -15.0}),
             ChannelSpec(NFM, -40_000.0, {"delta_squelch": True, "squelch_db": -15.0})]
    rx = RxPipeline(DeviceConfig(TX_RATE, log2_decim=6), chans, dev)
    check(rx.device_block == TX_RX_BLOCK, f"ctcss: Rx block {rx.device_block}")
    list(rx.run(lambda b, n: blocks[b], 1))  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [o["channels"] for _, o in rx.run(lambda b, n: blocks[b], n_rx)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1 = flat_decimate.launches
    check(k1 == n_rx and kpll_launches() == 0, f"ctcss: K1 {k1} launches for {n_rx} blocks")
    audio = [np.concatenate([o[c]["audio"] for o in outs]) for c in range(4)]
    block_out = len(audio[0]) // n_rx
    snr_open = tone_snr(audio[0][block_out:].astype(np.float64), 1000.0, 48_000.0)
    snr_delta = tone_snr(audio[2][block_out:].astype(np.float64), 1000.0, 48_000.0)
    wrong_peak = float(np.abs(audio[1][block_out:]).max())
    noise_peak = float(np.abs(audio[3][block_out:]).max())
    check(snr_open > 25.0, f"ctcss index 8: tone SNR {snr_open:.1f} dB")
    check(wrong_peak == 0.0, f"ctcss index 9: audio peak {wrong_peak} after the first block")
    check(snr_delta > 25.0, f"delta squelch on the carrier: tone SNR {snr_delta:.1f} dB")
    check(noise_peak == 0.0, f"delta squelch on noise: audio peak {noise_peak}")
    signal_s = n_rx * TX_RX_BLOCK / TX_RATE
    print(f"phase 9c ctcss: 9.6 MS/s /64, 4 NFM channels, {n_rx} blocks in {elapsed:.4f} s = "
          f"{elapsed / n_rx * 1e3:.3f} ms/block, real-time factor {signal_s / elapsed:.2f}; K1 "
          f"launches {k1}; index 8 open, tone SNR {snr_open:.2f} dB; index 9 silent after the "
          f"first block (peak {wrong_peak}); delta squelch open on the carrier (tone SNR "
          f"{snr_delta:.2f} dB), shut on noise (peak {noise_peak}) [{tag}]", flush=True)
    return k1


def bfm_blocks(n_blocks: int, block: int, rate: float) -> list[np.ndarray]:
    """A continuous stereo broadcast FM capture at the band centre: L a
    1 kHz tone, R silent, a 10 % pilot sin θ with the 38 kHz subcarrier
    sin 2θ, 75 kHz deviation, amplitude 0.5, int16 I/Q."""
    out, phase = [], 0.0
    for b in range(n_blocks):
        tt = (b * block + np.arange(block)) / rate
        left = np.sin(2 * np.pi * 1000.0 * tt)
        mpx = 0.45 * left * (1.0 + np.sin(2 * np.pi * 38_000.0 * tt)) + 0.1 * np.sin(
            2 * np.pi * 19_000.0 * tt)
        ph = phase + 2 * np.pi * 75_000.0 * np.cumsum(mpx) / rate
        phase = float(ph[-1])
        out.append(testsource.to_iq_int16((0.5 * np.exp(1j * ph)).astype(np.complex64)))
    return out


def _bfm_pipe(dev) -> RxPipeline:
    return RxPipeline(DeviceConfig(PRODUCT_RATE, log2_decim=5),
                      [ChannelSpec(BFM, 0.0, {}, 180_000.0)], dev)


def phase_bfm(dev: torch.device, tag: str) -> tuple[int, list[np.ndarray], np.ndarray]:
    """Broadcast FM behind K1: stereo separation, the pilot, the CPU twin."""
    n_blocks, n_cpu = 6, 2
    t0 = time.perf_counter()
    blocks = bfm_blocks(n_blocks, SLICE_BLOCK, PRODUCT_RATE)
    print(f"phase 9d bfm: generated {n_blocks} blocks of {SLICE_BLOCK} i16 samples in "
          f"{time.perf_counter() - t0:.2f} s (set-up) [{tag}]", flush=True)
    pipe = _bfm_pipe(dev)
    check(pipe.device_block == SLICE_BLOCK and pipe.fused_ingest and pipe.plans[0].signs == (),
          f"bfm: device block {pipe.device_block}, plan {pipe.plans[0]}")
    list(pipe.run(lambda b, n: blocks[b], 2))
    reset_counts()
    audio, elapsed = run_product(pipe, blocks)
    k1 = flat_decimate.launches
    check(k1 == n_blocks and kpll_launches() == 0, f"bfm: K1 {k1} launches for {n_blocks}")
    per_block = pipe.demod_cfgs[0].mono_plan.block_out
    check(audio.shape == (n_blocks * per_block, 2) and bool(np.isfinite(audio).all()),
          f"bfm: audio {audio.shape}")
    half = audio[len(audio) // 2:].astype(np.float64)
    snr = tone_snr(half[:, 0], 1000.0, 48_000.0)
    w = np.hanning(len(half))
    tone_bin = np.abs(np.fft.rfftfreq(len(half), 1 / 48_000.0) - 1000.0) < 20.0
    power = [np.sum(np.abs(np.fft.rfft(half[:, c] * w))[tone_bin] ** 2) for c in (0, 1)]
    separation = float(10 * np.log10(power[0] / max(power[1], 1e-30)))
    check(snr > 25.0, f"bfm: left tone SNR {snr:.1f} dB")
    check(separation >= 20.0, f"bfm: right rejects the left tone by {separation:.1f} dB")
    # the pilot level: BFMOutputs on K1's baseband, which is the channel (the
    # plan has no stage); the engine keeps BFM's audio only
    cfg = pipe.demod_cfgs[0]
    state, dstate = demod_bfm.make_state(cfg, dev), dec.init_flat_state(5, dev, raw=True)
    levels = []
    for b in range(2):
        dstate, bb = dec.decimate_flat_raw(dstate, torch.from_numpy(blocks[b]).to(dev), 5)
        state, outs = demod_bfm.process(state, bb, cfg)
        levels.append(float(outs.pilot_level))
    check(levels[-1] > PILOT_LOCK_LEVEL, f"bfm: pilot level {levels[-1]:.4f}")
    t0 = time.perf_counter()
    cpu_audio = np.concatenate([o["channels"][0]["audio"] for _, o in _bfm_pipe("cpu").run(
        lambda b, n: blocks[b], n_cpu)])
    cpu_s = time.perf_counter() - t0
    agree = agreement_db(cpu_audio, audio[:n_cpu * per_block])
    check(agree >= 80.0, f"bfm: card vs CPU pipeline {agree:.1f} dB")
    signal_s = n_blocks * SLICE_BLOCK / PRODUCT_RATE
    print(f"phase 9d bfm: 10 MS/s /32 stereo, {n_blocks} blocks in {elapsed:.4f} s = "
          f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor {signal_s / elapsed:.2f}; "
          f"K1 launches {k1}; left tone SNR {snr:.2f} dB, right {separation:.2f} dB under it; "
          f"pilot level {levels[-1]:.4f} (lock level {PILOT_LOCK_LEVEL}); card vs CPU on {n_cpu} "
          f"blocks "
          f"{agree:.2f} dB (CPU run {cpu_s:.1f} s) [{tag}]", flush=True)
    return k1, blocks, audio


def phase_bfm_server(blocks: list[np.ndarray], audio: np.ndarray, tag: str) -> int:
    """(d)'s capture played by a device set over HTTP on the card."""
    n_blocks = len(blocks)
    ref_pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    session = Session(device=DEVICE)
    srv = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bfm.sdriq")
            writer = sdriq.SdriqWriter(path, sample_rate=int(PRODUCT_RATE))
            for b in blocks:
                writer.write(b)
            writer.close()
            code, reply = http(base, "/sdrangel/devicesets", "POST")
            check(code == 201, f"bfm server: add device set {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "kind": "filesource", "file_path": path, "log2_decim": 5,
                "run_blocks": n_blocks, "publish_every": 1})
            check(code == 200, f"bfm server: device settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": BFM, "inputFrequencyOffset": 0.0})
            check(code == 201, f"bfm server: add channel {reply}")
            reset_counts()
            t0 = time.perf_counter()
            code, reply = http(base, "/sdrangel/deviceset/0/device/run", "POST")
            check(code == 200, f"bfm server: run {reply}")
            while http(base, "/sdrangel/deviceset/0")[1]["state"] == "running":
                check(time.perf_counter() - t0 < 300, "bfm server: still running after 300 s")
                time.sleep(0.01)
            launches = flat_decimate.launches
            _, device = http(base, "/sdrangel/deviceset/0/device/report")
            code, data = http(base, "/sdrangel/deviceset/0/channel/0/audio")
            check(code == 200, f"bfm server: audio {data}")
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"],
                  f"bfm server: {entry['state']} {entry['error']!r}")
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    with wave.open(io.BytesIO(data)) as w:
        check(w.getnchannels() == 2 and w.getframerate() == 48_000,
              f"bfm server: WAV {w.getnchannels()} channels at {w.getframerate()}")
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(-1, 2)
    check(launches == n_blocks, f"bfm server: K1 launched {launches} times for {n_blocks}")
    check(pcm.shape == ref_pcm.shape, f"bfm server: WAV {pcm.shape} vs {ref_pcm.shape}")
    lsb = int(np.abs(pcm[:, 0].astype(np.int32) - ref_pcm[:, 0]).max())
    agree = agreement_db(ref_pcm[:, 0], pcm[:, 0])
    check(agree >= 80.0, f"bfm server: left channel vs RxPipeline.run {agree:.1f} dB")
    print(f"phase 9e bfm server: {n_blocks} blocks over HTTP on a {DEVICE} Session, "
          f"{device['elapsedSeconds'] / n_blocks * 1e3:.3f} ms/block (device report), "
          f"real-time factor {device['realtimeFactor']:.2f}; K1 launches {launches}; the WAV's "
          f"left channel against RxPipeline.run: max {lsb} LSB, {agree:.2f} dB [{tag}]",
          flush=True)
    return launches


# -- phase 10: the data channels (LoRa, DSD, the channel analyzer, UDPSrc, ATV) ---

LORA = "sdrangel.channel.lorademod"
DSD = "sdrangel.channel.dsddemod"
CHANALYZER = "sdrangel.channel.chanalyzer"
UDPSRC = "sdrangel.channel.udpsrc"
ATV = "sdrangel.channel.demodatv"
#: set A's capture: 10.24 MS/s ÷32 = 320 kS/s. At 10 MS/s ÷32 the block solver
#: needs 204,800,000 device samples (UDPSrc's 512-sample hop and the DSD's
#: whole symbols at 78.125 kHz), past its 2^25 cap; 10.24 MS/s puts the
#: 48 kHz channels at 80 kHz
DATA_RATE, DATA_LOG2 = 10.24e6, 5
DATA_BLOCK = 26_214_400  # the solver's block for set A
DATA_BLOCKS, DATA_SERVER_BLOCKS = 6, 3
#: set A: LoRa's 125 kHz band at +80 kHz spans 17.5-142.5 kHz, inside K1's
#: flat passband (−0.004 dB at 140 kHz) and clear of the analyzer's 0-10 kHz
DSD_DEV = 5400.0  # the outer symbol's deviation (the dsd96 golden's)
DATA_SET_A = [
    (LORA, 80_000.0, {"spread_factor": 9, "bandwidth": 125_000.0}),
    (DSD, -40_000.0, {"fm_deviation": DSD_DEV}),
    (CHANALYZER, 5_000.0, {"bandwidth": 5000.0}),
    (UDPSRC, -90_000.0, {"fmt": "nfm", "fm_deviation": 3000.0}),
]
LORA_AMP, DSD_AMP, TONE_AMP, UDP_AMP, NOISE = 0.2, 0.2, 0.1, 0.2, 1e-3
DSD_SPS = DATA_RATE / 4800.0  # capture samples a DSD symbol
#: set B: PAL 625/25 captured at 20 MS/s, ÷2 -> 10 MS/s, 640 samples a line
ATV_RATE, ATV_BLOCKS = 20e6, 5
DSD_PHASES = 8  # symbol-clock phases tried by the DSD sweep


def _turns(n: torch.Tensor, freq: float, rate: float) -> torch.Tensor:
    """2π·frac(freq·n/rate) in float64 (every set-A frequency over the rate
    is a binary fraction, so the product is exact)."""
    return 2.0 * np.pi * torch.remainder(n.to(torch.float64) * (freq / rate), 1.0)


def _i16(x: torch.Tensor) -> np.ndarray:
    return torch.round(torch.view_as_real(x) * 32767.0).to(torch.int16).cpu().numpy()


def dsd_dibits(rng, n_sym: int) -> np.ndarray:
    """DMR base-station voice bursts (TS 102 361-1 §6.1: 54 voice dibits,
    the 24-dibit sync, 54 voice dibits and 12 more), random payload."""
    bursts = [np.concatenate([rng.integers(0, 4, 54), dsdsync.DMR_BS_VOICE,
                              rng.integers(0, 4, 66)])
              for _ in range(n_sym // dsdsync.DMR_BURST_DIBITS + 1)]
    return np.concatenate(bursts)[:n_sym].astype(np.int8)


def dsd_block(dev, dibits: np.ndarray, start: int, count: int, phase: float,
              carry: float, offset: float, amp: float) -> tuple[torch.Tensor, float]:
    """`count` capture samples from `start` of the dibits as rectangular 4FSK
    (DSDcc's levels: ±1, ±3 → ±dev/3, ±dev), the symbol clock `phase`
    symbols late, at `offset`: (samples, the deviation phase carried)."""
    n = torch.arange(start, start + count, device=dev, dtype=torch.int64)
    m = torch.clamp(torch.floor(n.to(torch.float64) / DSD_SPS - phase), min=0).to(torch.int64)
    levels = torch.from_numpy(dsdsync.DIBIT_LEVELS[dibits].astype(np.float64) / 3.0 * DSD_DEV)
    dphi = carry + torch.cumsum(levels.to(dev)[m], 0) * (2.0 * np.pi / DATA_RATE)
    return amp * torch.polar(torch.ones_like(dphi), dphi + _turns(n, offset, DATA_RATE)), float(
        dphi[-1])


def data_set_a(dev, n_blocks: int, dsd_phase: float, seed: int = 10):
    """Set A's capture, made on `dev` in float64 block by block: LoRa SF9
    symbols at +80 kHz, DMR 4FSK at −40 kHz, a tone at +5 kHz, an FM tone
    (1 kHz, 3 kHz deviation) at −90 kHz and noise, as int16 host blocks.
    Returns (blocks, LoRa symbols sent, dibits sent)."""
    rng = np.random.default_rng(seed)
    nb = 512
    total = n_blocks * DATA_BLOCK
    syms = rng.integers(0, nb, int(total / DATA_RATE * 125_000.0 / nb) + 2)
    dibits = dsd_dibits(rng, int(total / DSD_SPS) + 2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sym_t = torch.from_numpy(syms.astype(np.float64)).to(dev)
    blocks, carry = [], 0.0
    for b in range(n_blocks):
        n = torch.arange(b * DATA_BLOCK, (b + 1) * DATA_BLOCK, device=dev, dtype=torch.int64)
        chips = n.to(torch.float64) * (125_000.0 / DATA_RATE)
        m = torch.floor(chips / nb)
        u = torch.remainder(chips - m * nb + sym_t[m.to(torch.int64)], nb)
        lora = 2.0 * np.pi * (u * u / (2.0 * nb) - u / 2.0) + _turns(n, 80_000.0, DATA_RATE)
        x = LORA_AMP * torch.polar(torch.ones_like(lora), lora)
        fsk, carry = dsd_block(dev, dibits, b * DATA_BLOCK, DATA_BLOCK, dsd_phase, carry,
                               -40_000.0, DSD_AMP)
        x = x + fsk
        tone = _turns(n, 5_000.0, DATA_RATE)
        x = x + TONE_AMP * torch.polar(torch.ones_like(tone), tone)
        fm = _turns(n, -90_000.0, DATA_RATE) + 3.0 * torch.sin(_turns(n, 1000.0, DATA_RATE))
        x = x + UDP_AMP * torch.polar(torch.ones_like(fm), fm)
        x = x + NOISE * torch.randn(x.shape, dtype=torch.complex128, device=dev, generator=gen)
        blocks.append(_i16(x.to(torch.complex64)))
    return blocks, syms, dibits


def best_lag_share(got: np.ndarray, sent: np.ndarray, lags, skip: int) -> tuple[float, int]:
    """The share of got[skip:] equal to sent shifted by the best lag."""
    best = (0.0, 0)
    for lag in lags:
        i = np.arange(skip, len(got))
        j = i + lag
        ok = (j >= 0) & (j < len(sent))
        best = max(best, (float(np.mean(got[i[ok]] == sent[j[ok]])), lag))
    return best


def dsd_symbol_phase(dev) -> tuple[float, list[float]]:
    """The DSD channel's symbol timing loop moves its phase ~0.1 sample a
    block whatever the block's length (ROADMAP.md §3), so a capture whose
    symbol clock sits far from the loop's starting instant decodes at
    54-95 % for tens of blocks. A transmitter's preamble gives a real
    receiver that time; here the capture's symbol clock takes the phase,
    of DSD_PHASES tried on one block of the DSD channel alone, whose
    dibits agree best with the sent ones (the first block's symbols are
    all taken at the loop's starting instant). Returns (phase, shares)."""
    spec = [ChannelSpec(DSD, -40_000.0, DATA_SET_A[1][2], 48_000.0)]
    pipe = RxPipeline(DeviceConfig(DATA_RATE, log2_decim=DATA_LOG2), spec, dev,
                      block_size=1 << 16)
    rng = np.random.default_rng(11)
    dibits = dsd_dibits(rng, int(pipe.device_block / DSD_SPS) + 2)
    shares = []
    for k in range(DSD_PHASES):
        x, _ = dsd_block(dev, dibits, 0, pipe.device_block, k / DSD_PHASES, 0.0, -40_000.0, 0.5)
        _, outs = next(iter(pipe.run(lambda b, n: _i16(x), 1)))
        got = outs["channels"][0]["data"]["dibits"]
        shares.append(best_lag_share(got, dibits, range(-120, 21), len(got) // 2)[0])
    return int(np.argmax(shares)) / DSD_PHASES, shares


def _data(outs: list[dict], c: int, key: str) -> np.ndarray:
    return np.concatenate([np.atleast_1d(o["channels"][c]["data"][key]) for o in outs])


def stage_ms(fn, iters: int = 5) -> tuple[float, float]:
    """(host ms, device ms) of fn() alone: the host clock from the call to
    the end of a synchronize, and CUDA events around the call, each the mean
    of `iters` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    host = dev_ms = 0.0
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host += time.perf_counter() - t0
        dev_ms += start.elapsed_time(end)
    return host / iters * 1e3, dev_ms / iters


def data_layer_ms(pipe: RxPipeline, raw: np.ndarray) -> dict:
    """Each layer of one set-A block alone: the upload, K1, each channel
    (its channelizer, demod and adapter), the spectrum and scope taps, the
    packing of the outputs and their read-back."""
    state = pipe.init_state()
    dev_raw = pipe.upload(raw)
    dstate, bb = dec.decimate_flat_raw(state["dev_casc"], dev_raw, pipe.frontend.log2_decim)
    layers = {"upload": lambda: pipe.upload(raw),
              "K1": lambda: dec.decimate_flat_raw(state["dev_casc"], dev_raw,
                                                  pipe.frontend.log2_decim)}
    demods, chans = pipe.channel_states(state), pipe.channel_states(state, "chan")
    for c, (plan, kind, cfg) in enumerate(zip(pipe.plans, pipe.kinds, pipe.demod_cfgs)):
        def channel(c=c, plan=plan, kind=kind, cfg=cfg):
            _, y = chan.channelize(chans[c], bb, plan)
            _, result = kind.process(demods[c], y, cfg)
            return kind.adapter(result)
        layers[kind.uri.rsplit(".", 1)[-1]] = channel
    layers["spectrum+scope"] = lambda: (
        dsp_spectrum.power_spectrum(state["spectrum"], bb, pipe.spectrum_cfg),
        dsp_scope.project(bb[:1024], dsp_scope.Projection.MAG_DB))
    _, flat = pipe.step_packed(state, dev_raw)
    _, outs = pipe.step(state, dev_raw)
    layers["pack"] = lambda: pack_outs(outs)
    layers["read-back"] = lambda: fetch(flat)
    layers["step"] = lambda: pipe.step_packed(state, dev_raw)
    return {name: stage_ms(fn) for name, fn in layers.items()}


def _agree_outs(cpu: list[dict], card: list[dict]) -> tuple[float, int, int]:
    """Card against CPU over the blocks of both: the least agreement (dB)
    of the float outputs (the spectrum as linear power), and (dibits equal,
    dibits compared): every LoRa symbol and squelch flag must be equal, and
    every dibit whose CPU soft value is clear of a slicer threshold (the
    squelch's first 480 samples are zeros whose FFT-filtered ±1e-9 residue
    falls either side of 0)."""
    worst, same, compared = np.inf, 0, 0
    for co, go in zip(cpu, card):
        for c, (cc, gc) in enumerate(zip(co["channels"], go["channels"])):
            for k, want in cc["data"].items():
                got = gc["data"][k]
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"data {c} {k}: card {got.shape} {got.dtype}, CPU {want.shape} {want.dtype}")
                if k == "dibits":
                    soft = cc["data"]["soft_symbols"]
                    level = soft / max(1.5 * float(np.abs(soft).mean()), 1e-6)
                    clear = (np.abs(soft) > 2e-5) & (np.abs(np.abs(level) - 2 / 3) > 1e-3)
                    check(np.array_equal(got[clear], want[clear]), "dibits: card vs CPU differ")
                    same, compared = same + int(clear.sum()), compared + clear.size
                elif want.dtype != np.float32:
                    check(np.array_equal(got, want), f"data {c} {k}: card vs CPU differ")
                else:
                    lin = (lambda v: 10.0 ** (v / 10.0)) if k == "spectrum" else (lambda v: v)
                    worst = min(worst, agreement_db(lin(want.astype(np.float64)),
                                                    lin(got.astype(np.float64))))
    return worst, same, compared


def phase_data(dev: torch.device, tag: str) -> dict:
    """Set A at full width: LoRa, DSD, the channel analyzer and UDPSrc
    behind K1 in one RxPipeline; checks, card against CPU, the profiler's
    device time and each layer alone."""
    specs = [ChannelSpec(u, o, s, requested_rate(u, s)) for u, o, s in DATA_SET_A]
    pipe = RxPipeline(DeviceConfig(DATA_RATE, log2_decim=DATA_LOG2), specs, dev)
    check(pipe.device_block == DATA_BLOCK and pipe.fused_ingest,
          f"set A: device block {pipe.device_block}, plans {pipe.plans}")
    t0 = time.perf_counter()
    phase, shares = dsd_symbol_phase(dev)
    blocks, syms, dibits = data_set_a(dev, DATA_BLOCKS, phase)
    print(f"phase 10a data: DSD symbol-clock phase {phase:.3f} of {DSD_PHASES} tried on one "
          f"block of the DSD channel alone, dibit shares " + ", ".join(f"{s:.4f}" for s in shares)
          + f"; generated {DATA_BLOCKS} blocks of {DATA_BLOCK} i16 samples on the card in "
          f"{time.perf_counter() - t0:.2f} s (set-up) [{tag}]", flush=True)
    list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up: cuFFT plans, the kernel library
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [o for _, o in pipe.run(lambda b, n: blocks[b], DATA_BLOCKS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1 = flat_decimate.launches
    check(k1 == DATA_BLOCKS and flat_decimate_tc.launches == 0 and kpll_launches() == 0,
          f"set A: K1 {k1}, K1-TC {flat_decimate_tc.launches} launches for {DATA_BLOCKS}")
    # LoRa: one symbol a frame, up to the chain's constant bin offset (its
    # delay in chips). The demod has no fractional timing recovery (the
    # reference's detect() neither), so a delay off the chip grid splits a
    # frame's peak between two neighbouring bins: the check takes the bin
    # and its neighbours, and the exact share is printed beside it
    got = _data(outs, 0, "symbols")
    check(len(got) == DATA_BLOCKS * 625, f"LoRa: {len(got)} frames")
    offs = (got[1:].astype(np.int64) - syms[1:len(got)]) % 512
    modal = int(np.bincount(offs).argmax())
    lora_exact = float(np.mean(offs == modal))
    lora_share = float(np.mean(np.abs((offs - modal + 256) % 512 - 256) <= 1))
    check(lora_share >= 0.99, f"LoRa: {lora_share:.4f} of frames within a bin of the modal "
                              f"offset {modal}")
    # DSD: the dibits at the best lag, and the DMR syncs found by the host
    got = _data(outs, 1, "dibits")
    dsd_share, lag = best_lag_share(got, dibits, range(-120, 21), 200)
    check(dsd_share >= 0.99, f"DSD: {dsd_share:.4f} of dibits at lag {lag}")
    sync = DsdHostSync()
    for o in outs:
        report = sync.feed(o["channels"][1]["data"]["dibits"])
    sent_bursts = (len(got) + lag - 200) // dsdsync.DMR_BURST_DIBITS
    found = report["syncCounts"].get("dmr:bs_voice", 0)
    check(found >= 0.95 * sent_bursts, f"DSD: {found} DMR syncs of {sent_bursts} sent")
    # the analyzer's power against the tone's; the UDPSrc NFM tone
    power = float(outs[-1]["channels"][2]["data"]["channelPowerDB"])
    tone_db = 20.0 * np.log10(TONE_AMP)
    check(abs(power - tone_db) <= 0.5, f"chanalyzer: {power:.2f} dB against {tone_db:.2f}")
    scalar = _data(outs[DATA_BLOCKS // 2:], 3, "scalar")
    udp_snr = tone_snr(scalar.astype(np.float64), 1000.0, 48_000.0)
    check(udp_snr > 25.0 and bool(outs[-1]["channels"][3]["data"]["squelch"]),
          f"udpsrc: tone SNR {udp_snr:.1f} dB")
    # card against the CPU pipeline on the first 2 blocks
    t0 = time.perf_counter()
    cpu_pipe = RxPipeline(DeviceConfig(DATA_RATE, log2_decim=DATA_LOG2), specs, "cpu")
    cpu = [o for _, o in cpu_pipe.run(lambda b, n: blocks[b], 2)]
    cpu_s = time.perf_counter() - t0
    agree, same, compared = _agree_outs(cpu, outs[:2])
    check(agree >= 80.0 and same >= compared - 60,
          f"set A card vs CPU: {agree:.1f} dB, dibits {same} of {compared} compared")
    signal_s = DATA_BLOCKS * DATA_BLOCK / DATA_RATE
    print(f"phase 10a data: 10.24 MS/s /32, LoRa SF9 +80 kHz, DSD -40 kHz, chanalyzer +5 kHz, "
          f"udpsrc nfm -90 kHz; {DATA_BLOCKS} blocks in {elapsed:.4f} s = "
          f"{elapsed / DATA_BLOCKS * 1e3:.3f} ms/block, real-time factor "
          f"{signal_s / elapsed:.2f}; K1 launches {k1}; LoRa {lora_share:.4f} of {len(offs)} "
          f"frames within a bin of the modal offset {modal}, {lora_exact:.4f} on it; DSD {dsd_share:.4f} of dibits at lag {lag}, {found} DMR "
          f"syncs of {sent_bursts} bursts; chanalyzer {power:.3f} dB (tone {tone_db:.3f}); "
          f"udpsrc tone SNR {udp_snr:.2f} dB; card vs CPU on 2 blocks {agree:.2f} dB, dibits "
          f"equal on {same} of {len(_data(cpu, 1, 'dibits'))} (the rest within 2e-5 of a "
          f"threshold), symbols and flags equal (CPU run {cpu_s:.1f} s) [{tag}]", flush=True)
    layers = data_layer_ms(pipe, blocks[0])
    print("phase 10a data: each layer of one block alone, host ms (to a synchronize) / "
          "device ms (CUDA events): " + ", ".join(f"{k} {h:.3f}/{d:.3f}"
                                                  for k, (h, d) in layers.items())
          + f" [{tag}]", flush=True)
    print(f"phase 10a data: device time of 3 blocks by torch.profiler, against the timed run's "
          f"{elapsed / DATA_BLOCKS * 1e3:.3f} ms/block [{tag}]", flush=True)
    _device_time(lambda: list(pipe.run(lambda b, n: blocks[b], 3)), 3,
                 elapsed / DATA_BLOCKS * 3)
    return {"k1": k1, "blocks": blocks, "pipe": pipe}


def atv_test_frame() -> np.ndarray:
    """(625, 64) luma: a ramp across the left half, bars of 4 columns across
    the right half, on every line."""
    frame = np.zeros((625, 64), np.float32)
    frame[:, :32] = np.linspace(0.0, 1.0, 32, dtype=np.float32)
    frame[:, 32:] = (np.arange(32) // 4 % 2).astype(np.float32)
    return frame


def phase_atv(dev: torch.device, tag: str) -> int:
    """Set B: the port's ATV modulator's PAL picture at 20 MS/s through K1
    ÷2 and the ATV receiver."""
    mcfg = ATVModConfig(channel_rate=ATV_RATE, modulation="am")
    pipe = RxPipeline(DeviceConfig(ATV_RATE, log2_decim=1),
                      [ChannelSpec(ATV, 0.0, {}, requested_rate(ATV, {}))], dev)
    spl = pipe.demod_cfgs[0].samples_per_line
    check(pipe.device_block == 327_680 and spl == 640 and pipe.plans[0].signs == (),
          f"atv: device block {pipe.device_block}, {spl} samples a line")
    frame = torch.from_numpy(atv_test_frame()).to(dev)
    comp = atv_composite(mcfg, frame)  # one frame, 1280 samples a line
    video = comp.repeat(-(-ATV_BLOCKS * pipe.device_block // comp.numel()))
    _, x = atv_modulate(make_atv_state(mcfg, dev), video[:ATV_BLOCKS * pipe.device_block], mcfg)
    raw = _i16(x)
    blocks = [raw[b * pipe.device_block:(b + 1) * pipe.device_block] for b in range(ATV_BLOCKS)]
    list(pipe.run(lambda b, n: blocks[b], 2))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [o for _, o in pipe.run(lambda b, n: blocks[b], ATV_BLOCKS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1 = flat_decimate.launches
    check(k1 == ATV_BLOCKS, f"atv: K1 {k1} launches for {ATV_BLOCKS}")
    phases = [float(o["channels"][0]["data"]["sync_phase"]) for o in outs]
    quality = min(float(o["channels"][0]["data"]["sync_quality"]) for o in outs)
    check(len(set(phases[1:])) == 1, f"atv: sync phase moves across blocks {phases}")
    check(quality > 0.3, f"atv: sync notch {quality:.3f}")
    # the mean recovered line against the sent composite line (÷2), active
    # region, at the best circular alignment: test_atv.py:53's ρ > 0.95
    lines = _data(outs, 0, "lines")
    mean_line = lines.mean(axis=0)
    sent = comp[:2 * spl].cpu().numpy()[::2]  # the first line, at the channel rate
    active = slice(int(0.08 * spl) + spl // 16 + 4, spl - 4)
    rho = max(float(np.corrcoef(np.roll(mean_line, lag)[active], sent[active])[0, 1])
              for lag in range(spl))
    check(rho > 0.95, f"atv: mean line against the test frame rho {rho:.4f}")
    cpu_pipe = RxPipeline(DeviceConfig(ATV_RATE, log2_decim=1),
                          [ChannelSpec(ATV, 0.0, {}, requested_rate(ATV, {}))], "cpu")
    cpu = [o for _, o in cpu_pipe.run(lambda b, n: blocks[b], 2)]
    agree, _, _ = _agree_outs(cpu, outs[:2])
    check(agree >= 80.0, f"atv: card vs CPU {agree:.1f} dB")
    signal_s = ATV_BLOCKS * pipe.device_block / ATV_RATE
    print(f"phase 10b atv: 20 MS/s /2 PAL 625/25 AM from atv_modulate, {ATV_BLOCKS} blocks "
          f"({ATV_BLOCKS * pipe.device_block // 2 // spl} lines) in {elapsed:.4f} s = "
          f"{elapsed / ATV_BLOCKS * 1e3:.3f} ms/block, real-time factor "
          f"{signal_s / elapsed:.2f}; K1 launches {k1}; sync phase {phases}, notch depth >= "
          f"{quality:.4f}; mean line against the test frame rho {rho:.4f}; card vs CPU on 2 "
          f"blocks {agree:.2f} dB [{tag}]", flush=True)
    return k1


def _trimmed(v: np.ndarray):
    """The data route's form of one array (api/server.py)."""
    if v.ndim == 0:
        return round(float(v), 5)
    a = v.reshape(-1) if v.ndim > 2 else v
    return np.round(a[..., -2048:], 5)


@contextlib.contextmanager
def server_process(tmp: str, what: str):
    """`python -m sdrangel_tpu_torch server --device cuda` on a free port in
    its own process, up and answering: yields (its base URL, a list that
    holds its log once it has stopped)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    log = open(os.path.join(tmp, "server.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrangel_tpu_torch", "server", "--device", DEVICE,
         "--api-port", str(port)], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    server_log: list[str] = []
    try:
        t0 = time.perf_counter()
        while True:
            try:
                if http(base, "/sdrangel")[0] == 200:
                    break
            except OSError:
                pass
            check(proc.poll() is None and time.perf_counter() - t0 < 120,
                  f"{what}: the server did not come up")
            time.sleep(0.2)
        yield base, server_log
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        server_log.append(log.read())
        log.close()


def phase_data_server(pipe: RxPipeline, blocks: list[np.ndarray], tag: str) -> None:
    """Set A's first blocks as a .sdriq, played by `python -m
    sdrangel_tpu_torch server` in its own process, driven over HTTP only,
    against `pipe` stepped on the same blocks with the session's per-block
    overrides (UDPSrc's offset through the f32 increment, as the session
    passes it)."""
    n_blocks = DATA_SERVER_BLOCKS
    state, outs = pipe.init_state(), []
    for raw in blocks[:n_blocks]:
        state, flat = pipe.step_packed(state, pipe.upload(raw), pipe.default_dyn())
        outs.append(pipe.to_host(flat))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "set_a.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(DATA_RATE))
        for b in blocks[:n_blocks]:
            writer.write(b)
        writer.close()
        with server_process(tmp, "data server") as (base, logs):
            check(http(base, "/sdrangel/devicesets", "POST")[0] == 201, "data server: add set")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "kind": "filesource", "file_path": path, "log2_decim": DATA_LOG2,
                "run_blocks": n_blocks, "publish_every": 1})
            check(code == 200, f"data server: device settings {reply}")
            for uri, offset, settings in DATA_SET_A:
                code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                    "channelType": uri, "inputFrequencyOffset": offset, **settings})
                check(code == 201, f"data server: add {uri} {reply}")
            t0 = time.perf_counter()
            check(http(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200,
                  "data server: run")
            while http(base, "/sdrangel/deviceset/0")[1]["state"] == "running":
                check(time.perf_counter() - t0 < 300, "data server: still running after 300 s")
                time.sleep(0.01)
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"],
                  f"data server: {entry['state']} {entry['error']!r}")
            _, device = http(base, "/sdrangel/deviceset/0/device/report")
            data = [http(base, f"/sdrangel/deviceset/0/channel/{j}/data")
                    for j in range(len(DATA_SET_A))]
            reports = [http(base, f"/sdrangel/deviceset/0/channel/{j}/report")[1]
                       for j in range(len(DATA_SET_A))]
            # the same blocks again in the warm process: the first run's
            # time holds the process's first cuFFT plans and kernel load
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                               {"run_blocks": 2 * n_blocks})
            check(code == 200, f"data server: device settings {reply}")
            t0 = time.perf_counter()
            check(http(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200,
                  "data server: second run")
            while http(base, "/sdrangel/deviceset/0")[1]["state"] == "running":
                check(time.perf_counter() - t0 < 300, "data server: still running after 300 s")
                time.sleep(0.01)
            _, warm = http(base, "/sdrangel/deviceset/0/device/report")
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"]
                  and warm["blocksProcessed"] == 2 * n_blocks,
                  f"data server: second run {entry['state']} {entry['error']!r} {warm}")
    server_log = logs[0]
    worst, worst_at = 0.0, ""
    for j, ((code, reply), rep) in enumerate(zip(data, reports)):
        check(code == 200 and reply["dataBlocks"] == n_blocks == rep["dataBlocks"],
              f"data server: channel {j} {code} {reply.get('dataBlocks')} {server_log[-2000:]}")
        want = outs[n_blocks - 1]["channels"][j]["data"]
        check(sorted(reply["data"]) == sorted(want) == rep["dataKeys"],
              f"data server: channel {j} keys {sorted(reply['data'])}")
        for k, v in want.items():
            got, exp = np.asarray(reply["data"][k], np.float64), np.asarray(_trimmed(v),
                                                                            np.float64)
            check(got.shape == exp.shape, f"data server: {j} {k} {got.shape} vs {exp.shape}")
            if k == "spectrum":  # dB: its deep bins compared as power relative to the peak
                got, exp = 10.0 ** ((got - exp.max()) / 10.0), 10.0 ** ((exp - exp.max()) / 10.0)
            err = float(np.abs(got - exp).max()) if got.size else 0.0
            worst, worst_at = max((worst, worst_at), (err, f"channel {j} {k}"))
    check(worst <= 1.5e-5, f"data server: data route vs the pipeline's block {worst:.2e} "
                         f"({worst_at})")
    sync = DsdHostSync()
    for o in outs[:n_blocks]:
        want_report = sync.feed(o["channels"][1]["data"]["dibits"])
    check(reports[1].get("dsd") == json.loads(json.dumps(want_report)),
          "data server: the DSD report differs from the frame sync of the pipeline's dibits")
    found = reports[1]["dsd"]["syncCounts"].get("dmr:bs_voice", 0)
    check(found > 0, "data server: no DMR sync in the DSD report")
    print(f"phase 10c data server: python -m sdrangel_tpu_torch server --device {DEVICE}, "
          f"set A's first {n_blocks} blocks from a .sdriq over HTTP, streamed: "
          f"{device['elapsedSeconds'] / n_blocks * 1e3:.3f} ms/block (device report), "
          f"real-time factor {device['realtimeFactor']:.2f} in the process's first run, "
          f"{warm['elapsedSeconds'] / n_blocks * 1e3:.3f} ms/block, real-time factor "
          f"{warm['realtimeFactor']:.2f} in its second; the data route of the 4 channels "
          f"within {worst:.1e} of RxPipeline's block {n_blocks - 1} (trimmed to 2048, 5 places); "
          f"dataBlocks {n_blocks}; the DSD report's {found} DMR syncs equal the frame sync of "
          f"the pipeline's dibits [{tag}]", flush=True)


DATV = "sdrangel.channel.demoddatv"
#: 11a: DVB-S at 250 kS/s (the reduced-bandwidth class amateur DATV stations
#: transmit) in an 8 MS/s capture; K1 ÷8 hands the channel 1 MS/s, 4 samples
#: a symbol. Blocks of the solver's ~1 s (2^20 channel samples, ~160 RS
#: packets)
DATV_RATE, DATV_LOG2, DATV_SYMBOL_RATE = 8e6, 3, 250_000.0
DATV_BLOCK = 1 << 23  # the solver's device block for a 2^20 target at ÷8
DATV_BLOCKS, DATV_DECODE_BLOCKS = 4, 2
DATV_ESN0_DB = 10.0
DATV_SETTINGS = {"symbol_rate": DATV_SYMBOL_RATE}
#: 11b: the session's blocks (2^16 at the channel) that make one 11a block
DATV_SERVER_BLOCKS = DATV_BLOCK >> (DATV_LOG2 + 16)
#: 11c: NFM at 48 kHz × 32, the rate class of a small SDR behind SDRdaemon
DAEMON_RATE, DAEMON_FEC, DAEMON_DROP_EVERY = 1_536_000.0, 16, 32
#: the Tx baseband at 192 kHz holds NFM at +20 kHz; the Rx set's K1 ÷4
DAEMON_LOG2_INTERP, DAEMON_LOG2_DECIM = 3, 2
DAEMON_AUDIO_S = 3.0

#: a UDP relay in its own process: forwards the sender's datagrams to the
#: port in argv[1], dropping every argv[2]-th, and swallows the receiver's
#: feedback (the sender does not adapt its FEC here)
RELAY = r"""
import socket, sys
sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 23)
sock.bind(("127.0.0.1", 0))
print(sock.getsockname()[1], flush=True)
target, drop, k = ("127.0.0.1", int(sys.argv[1])), int(sys.argv[2]), 0
while True:
    raw = sock.recv(4096)
    if raw.startswith(b"SDFB"):
        continue
    k += 1
    if k % drop:
        try:
            sock.sendto(raw, target)
        except OSError:
            pass
"""


def ts_stream(n_packets: int, seed: int) -> np.ndarray:
    """A transport stream of (n, 188) packets: groups of PAT, PMT and a
    4,000-byte H.264 PES of programme 7 (24 packets) then 40 random packets."""
    psi = tsdemux._section_packetize(0, tsdemux.make_pat({7: 0x120}), 0)
    psi += tsdemux._section_packetize(0x120, tsdemux.make_pmt(7, 0x300, {0x300: 0x1B}), 0)
    psi += tsdemux.make_pes_packets(0x300, bytes(range(200)) * 20, pts=12345)
    psi_arr = np.frombuffer(b"".join(psi), np.uint8).reshape(-1, dvbs.TS_PACKET)
    rng = np.random.default_rng(seed)
    groups = []
    while sum(len(g) for g in groups) < n_packets:
        rand = rng.integers(0, 256, size=(40, dvbs.TS_PACKET), dtype=np.uint8)
        rand[:, 0] = dvbs.SYNC_BYTE
        groups += [psi_arr, rand]
    return np.concatenate(groups)[:n_packets]


def dvbs_capture(dev, packets: np.ndarray, fec_rate: str, n_blocks: int, seed: int
                 ) -> tuple[list[np.ndarray], int]:
    """The packets as DVB-S QPSK (the port's dvbs encoder) at 250 kS/s in an
    8 MS/s capture: 32 samples a symbol, shaped on the card with
    create_rrc_filter (rolloff 0.35), white noise at DATV_ESN0_DB over the
    whole band, int16 blocks of DATV_BLOCK. Returns (blocks, symbols sent)."""
    chan_bits = dvbs.encode_transport(packets.reshape(-1))
    if fec_rate != "1/2":
        chan_bits = dvbs.puncture(chan_bits, fec_rate)
    sym = torch.from_numpy(demod_datv.bits_to_qpsk(chan_bits)).to(dev)
    sps = int(DATV_RATE / DATV_SYMBOL_RATE)
    total = n_blocks * DATV_BLOCK
    n_sym = min(len(sym), total // sps)
    up = torch.zeros(total, dtype=torch.complex64, device=dev)
    up[:n_sym * sps:sps] = sym[:n_sym] * sps
    h = torch.from_numpy(fftfilt.create_rrc_filter(1.0 / sps, 0.35, 4096)).to(dev)
    _, x = fftfilt.run_filt(fftfilt.make_state(4096, dev), up, h)
    p_sig = float(torch.mean(x[:n_sym * sps].abs() ** 2))
    # Es/N0 = P·sps/σ² for complex noise of variance σ² a sample
    sigma2 = p_sig * sps / 10.0 ** (DATV_ESN0_DB / 10.0)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((2, total), generator=g, device=dev) * float(np.sqrt(sigma2 / 2))
    y = (x + torch.complex(noise[0], noise[1])) * float(0.1 / np.sqrt(p_sig + sigma2))
    raw = _i16(y)
    return [raw[b * DATV_BLOCK:(b + 1) * DATV_BLOCK] for b in range(n_blocks)], n_sym


def _soft(outs: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    return _data(outs, 0, "soft_i"), _data(outs, 0, "soft_q")


def ts_check(ts: bytes, stats: dict, sent: np.ndarray, what: str) -> int:
    """RS failed on no packet, and the recovered packets equal the sent ones
    from a scrambler-group head (a multiple of 8) on. Returns that head."""
    got = np.frombuffer(ts, np.uint8).reshape(-1, dvbs.TS_PACKET)
    check(stats["rsFailed"] == 0 and len(got) == stats["packets"] > 0,
          f"{what}: {stats}, {len(got)} packets")
    starts = [k for k in range(0, len(sent) - len(got) + 1, 8)
              if np.array_equal(sent[k:k + len(got)], got)]
    check(len(starts) == 1, f"{what}: the {len(got)} recovered packets match the sent stream "
                            f"from group heads {starts}")
    return starts[0]


def phase_datv(dev: torch.device, tag: str) -> dict:
    """11a: DATV at full width through RxPipeline behind K1, the host FEC
    and the TS demux over the first blocks' soft symbols, a shorter FEC 3/4
    capture, card against CPU, the device's busy share."""
    spec = [ChannelSpec(DATV, 0.0, DATV_SETTINGS, requested_rate(DATV, DATV_SETTINGS))]
    pipe = RxPipeline(DeviceConfig(DATV_RATE, log2_decim=DATV_LOG2), spec, dev,
                      block_size=1 << 20)
    sps = pipe.demod_cfgs[0].sps
    check(pipe.device_block == DATV_BLOCK and pipe.fused_ingest and sps == 4
          and pipe.plans[0].signs == (), f"datv: device block {pipe.device_block}, sps {sps}, "
                                         f"plans {pipe.plans}")
    t0 = time.perf_counter()
    block_s = DATV_BLOCK / DATV_RATE
    n_packets = int(DATV_BLOCKS * block_s * DATV_SYMBOL_RATE / 1632) + 16  # 1632 symbols a packet
    sent = ts_stream(n_packets, seed=13)
    blocks, n_sym = dvbs_capture(dev, sent, "1/2", DATV_BLOCKS, seed=14)
    sent34 = ts_stream(120, seed=15)
    blocks34, n_sym34 = dvbs_capture(dev, sent34, "3/4", 1, seed=16)
    print(f"phase 11a datv: {n_packets} TS packets at FEC 1/2 and 120 at FEC 3/4 encoded on the "
          f"host and shaped on the card ({n_sym} and {n_sym34} symbols), {DATV_BLOCKS} + 1 "
          f"blocks of {DATV_BLOCK} i16 samples in {time.perf_counter() - t0:.2f} s (set-up) "
          f"[{tag}]", flush=True)
    list(pipe.run(lambda b, n: blocks[b], 1))  # warm-up: cuFFT plans, the kernel library
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [o for _, o in pipe.run(lambda b, n: blocks[b], DATV_BLOCKS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1 = flat_decimate.launches
    check(k1 == DATV_BLOCKS and flat_decimate_tc.launches == 0 and kpll_launches() == 0,
          f"datv: K1 {k1}, K1-TC {flat_decimate_tc.launches} launches for {DATV_BLOCKS}")
    soft_i, soft_q = _soft(outs)
    check(soft_i.shape == ((DATV_BLOCKS * DATV_BLOCK >> DATV_LOG2) // sps,) and np.isfinite(soft_i).all()
          and np.isfinite(soft_q).all(), f"datv: soft symbols {soft_i.shape}")
    n_dec = (DATV_DECODE_BLOCKS * DATV_BLOCK >> DATV_LOG2) // sps
    t0 = time.perf_counter()
    ts, stats = demod_datv.recover_ts(soft_i[:n_dec], soft_q[:n_dec], max_packets=2048)
    host_s = time.perf_counter() - t0
    head = ts_check(ts, stats, sent, "datv 1/2")
    demux = tsdemux.TsDemux()
    demux.feed(ts)
    progs = {p["program"]: p for p in demux.summary()["programs"]}
    check(7 in progs and progs[7]["streams"][0]["codec"] == "H.264 video",
          f"datv: programme map {demux.summary()}")
    outs34 = [o for _, o in pipe.run(lambda b, n: blocks34[b], 1)]
    soft34 = [s[:n_sym34] for s in _soft(outs34)]
    t0 = time.perf_counter()
    ts34, stats34 = demod_datv.recover_ts(*soft34, fec_rate="3/4", max_packets=2048)
    host34_s = time.perf_counter() - t0
    head34 = ts_check(ts34, stats34, sent34, "datv 3/4")
    t0 = time.perf_counter()
    cpu_pipe = RxPipeline(DeviceConfig(DATV_RATE, log2_decim=DATV_LOG2), spec, "cpu",
                          block_size=1 << 20)
    cpu = [o for _, o in cpu_pipe.run(lambda b, n: blocks[b], 2)]
    cpu_s = time.perf_counter() - t0
    agree, _, _ = _agree_outs(cpu, outs[:2])
    check(agree >= 80.0, f"datv: card vs CPU {agree:.1f} dB")
    signal_s = DATV_BLOCKS * block_s
    dec_signal_s = DATV_DECODE_BLOCKS * block_s
    print(f"phase 11a datv: 8 MS/s /8, DVB-S 250 kS/s QPSK FEC 1/2 at Es/N0 {DATV_ESN0_DB} dB; "
          f"{DATV_BLOCKS} blocks in {elapsed:.4f} s = {elapsed / DATV_BLOCKS * 1e3:.3f} ms/block, "
          f"real-time factor {signal_s / elapsed:.2f}; K1 launches {k1}; host recover_ts over "
          f"{DATV_DECODE_BLOCKS} blocks ({2 * n_dec} soft bits): {host_s:.3f} s = "
          f"{host_s / dec_signal_s:.3f} s per second of signal, {stats}, packets equal to the "
          f"sent ones from group head {head}, programme 7 {progs[7]['streams'][0]['codec']}; "
          f"FEC 3/4 ({n_sym34} symbols): {host34_s:.3f} s, {stats34}, from head {head34}; card "
          f"vs CPU on 2 blocks {agree:.2f} dB (CPU run {cpu_s:.1f} s) [{tag}]", flush=True)
    print(f"phase 11a datv: device time of 2 blocks by torch.profiler, against the timed run's "
          f"{elapsed / DATV_BLOCKS * 1e3:.3f} ms/block [{tag}]", flush=True)
    _device_time(lambda: list(pipe.run(lambda b, n: blocks[b], 2)), 2,
                 elapsed / DATV_BLOCKS * 2)
    return {"k1": k1, "blocks": blocks, "stats": stats, "host_s_per_s": host_s / dec_signal_s,
            "ms_block": elapsed / DATV_BLOCKS * 1e3}


def phase_datv_server(blocks: list[np.ndarray], tag: str) -> None:
    """11b: 11a's first block as a .sdriq through the server process over
    HTTP: a DATV channel in continuous mode, its "datv" report polled
    through the run (each decode pass's host seconds, the worker's stall)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "datv.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(DATV_RATE))
        writer.write(blocks[0])
        writer.close()
        with server_process(tmp, "datv server") as (base, server_log):
            check(http(base, "/sdrangel/devicesets", "POST")[0] == 201, "datv server: add set")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "kind": "filesource", "file_path": path, "log2_decim": DATV_LOG2,
                "run_blocks": DATV_SERVER_BLOCKS, "publish_every": 1})
            check(code == 200, f"datv server: device settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": DATV, **DATV_SETTINGS, "datvContinuous": True})
            check(code == 201, f"datv server: add channel {reply}")
            passes = {}
            t0 = time.perf_counter()
            check(http(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200,
                  "datv server: run")
            while True:
                state = http(base, "/sdrangel/deviceset/0")[1]["state"]
                rep = http(base, "/sdrangel/deviceset/0/channel/0/report")[1]
                if "datv" in rep:
                    passes[rep["datv"]["rounds"]] = rep["datv"]["hostSeconds"]
                if state != "running":
                    break
                check(time.perf_counter() - t0 < 300, "datv server: still running after 300 s")
                time.sleep(0.05)
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"],
                  f"datv server: {entry['state']} {entry['error']!r}")
            _, device = http(base, "/sdrangel/deviceset/0/device/report")
            _, rep = http(base, "/sdrangel/deviceset/0/channel/0/report")
            code, data = http(base, "/sdrangel/deviceset/0/channel/0/data")
    datv = rep.get("datv") or {}
    passes[datv.get("rounds")] = datv.get("hostSeconds")
    check(datv.get("rounds", 0) >= 1 and datv["packets"] > 100 and datv["rsFailed"] == 0,
          f"datv server: {datv} {server_log[0][-2000:]}")
    progs = {p["program"]: p for p in datv["ts"]["programs"]}
    check(7 in progs and progs[7]["streams"][0]["codec"] == "H.264 video",
          f"datv server: programme map {datv['ts']}")
    check(code == 200 and sorted(data["data"]) == ["soft_i", "soft_q"] == rep["dataKeys"]
          and data["dataBlocks"] == DATV_SERVER_BLOCKS
          and len(data["data"]["soft_i"]) == min(2048, (DATV_BLOCK >> DATV_LOG2) // 4
                                                  // DATV_SERVER_BLOCKS),
          f"datv server: data route {code} {sorted(data.get('data', {}))}")
    stall = sum(v for v in passes.values() if v is not None)
    print(f"phase 11b datv server: python -m sdrangel_tpu_torch server --device {DEVICE}, "
          f"11a's first block as a .sdriq over HTTP in {DATV_SERVER_BLOCKS} session blocks: "
          f"{device['elapsedSeconds'] / DATV_SERVER_BLOCKS * 1e3:.3f} ms/block (device report, "
          f"decode passes included), real-time factor {device['realtimeFactor']:.2f}; decode "
          f"passes (round: host s, the worker's stall) "
          + ", ".join(f"{r}: {s:.3f}" for r, s in sorted(passes.items()) if s is not None)
          + f" = {stall:.3f} s of {device['elapsedSeconds']:.3f} s; report rounds "
          f"{datv['rounds']}, packets {datv['packets']}, rsFailed {datv['rsFailed']}, "
          f"rotation {datv['rotation']}, programme 7 {progs[7]['streams'][0]['codec']}; /data "
          f"carries soft_i/soft_q [{tag}]", flush=True)


def _longest_active_run(audio: np.ndarray) -> np.ndarray:
    """The longest stretch of audio the network source did not fill with
    silence (a stream gap)."""
    active = np.abs(audio) > 1e-4
    edges = np.flatnonzero(np.diff(np.concatenate([[0], active.view(np.int8), [0]])))
    start, end = max(zip(edges[0::2], edges[1::2]), key=lambda r: r[1] - r[0])
    return audio[start:end]


def phase_daemon(tag: str) -> int:
    """11c: the remote radio, a Tx set on the card in a `server` process of
    its own (NFM +20 kHz, 1.536 MS/s) into a daemonsink (FEC 16); a relay
    process that drops every 32nd datagram; and here an Rx set on the card
    whose daemonsource feeds K1 ÷4 and NFM at +20 kHz."""
    check(fec.native_available(), "daemon: the native GF(256) codec did not build")
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        rx_port = probe.getsockname()[1]
    relay = subprocess.Popen([sys.executable, "-c", RELAY, str(rx_port),
                              str(DAEMON_DROP_EVERY)], stdout=subprocess.PIPE, text=True)
    session = Session(device=DEVICE)
    try:
        relay_port = int(relay.stdout.readline())
        rx = session.add_device_set("rx")
        rx.update_source({"kind": "daemonsource", "daemon_port": rx_port,
                          "sample_rate": DAEMON_RATE, "log2_decim": DAEMON_LOG2_DECIM})
        rx.add_channel(NFM, {"inputFrequencyOffset": 20_000.0, "squelch_db": -60.0,
                             "squelch_gate_ms": 1.0})
        with tempfile.TemporaryDirectory() as tmp, server_process(tmp, "daemon Tx") as (
                base, _):
            check(http(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})[0] == 201,
                  "daemon: add the Tx set")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "kind": "daemonsink", "sample_rate": DAEMON_RATE,
                "log2_interp": DAEMON_LOG2_INTERP, "daemon_port": relay_port,
                "daemon_fec": DAEMON_FEC, "throttle": True})
            check(code == 200, f"daemon: sink settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": NFM_MOD, "inputFrequencyOffset": 20_000.0,
                "toneFrequency": 1000.0, "fm_deviation": 5000.0})
            check(code == 201, f"daemon: add the modulator {reply}")
            check(http(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200,
                  "daemon: Tx run")
            t0 = time.perf_counter()
            while (tx := http(base, "/sdrangel/deviceset/0/device/report")[1])[
                    "blocksProcessed"] < 3:
                check(tx["state"] == "running" and time.perf_counter() - t0 < 60,
                      f"daemon: Tx {tx}")
                time.sleep(0.05)
            reset_counts()
            rx.start()
            t0 = time.perf_counter()
            audio, failed_at_1s = [], None
            while sum(len(a) for a in audio) < DAEMON_AUDIO_S * 48_000:
                check(not rx.error and time.perf_counter() - t0 < 60, f"daemon: Rx {rx.error!r}")
                time.sleep(0.05)
                if failed_at_1s is None and rx.elapsed_s >= 1.0:
                    failed_at_1s = rx.daemon_stats.frames_failed
                audio.append(rx.drain_audio(0))
            rx.stop()
            rx_s = rx.elapsed_s
            tx = http(base, "/sdrangel/deviceset/0/device/report")[1]
            check(http(base, "/sdrangel/deviceset/0/device/run", "DELETE")[0] == 200,
                  "daemon: Tx stop")
        check(tx["state"] == "running" and not rx.error and not rx.running,
              f"daemon: Tx {tx} Rx {rx.error!r}")
    finally:
        session.shutdown()
        relay.terminate()
        relay.wait(timeout=10)
    k1 = flat_decimate.launches
    stats = rx.daemon_stats
    check(k1 == rx.blocks_processed > 0 and flat_decimate_tc.launches == 0,
          f"daemon: K1 {k1} launches for {rx.blocks_processed} Rx blocks")
    check(stats.blocks_recovered > 0 and failed_at_1s is not None
          and stats.frames_failed == failed_at_1s,
          f"daemon: {stats}, {failed_at_1s} frames failed in the first second")
    run = _longest_active_run(np.concatenate(audio))
    snr = tone_snr(run[len(run) // 4:].astype(np.float64), 1000.0, 48_000.0)
    check(len(run) >= 2 * 48_000 and snr > 25.0,
          f"daemon: longest active run {len(run)} samples, tone SNR {snr:.1f} dB")
    print(f"phase 11c daemon: Tx NFM +20 kHz at {DAEMON_RATE / 1e6} MS/s "
          f"x{1 << DAEMON_LOG2_INTERP} into a daemonsink (FEC {DAEMON_FEC}) in a server "
          f"process, a relay process dropping every {DAEMON_DROP_EVERY}th datagram, an Rx "
          f"daemonsource /{1 << DAEMON_LOG2_DECIM} NFM +20 kHz here, both on {DEVICE}: "
          f"{stats.frames_ok / rx_s:.1f} superframes/s, {stats.blocks_received / rx_s:.0f} "
          f"datagrams/s over {rx_s:.2f} s; Rx real-time factor {rx.realtime_factor:.3f}, Tx "
          f"{tx['realtimeFactor']:.3f} (device report); {stats}, {failed_at_1s} failed in the "
          f"first second; K1 launches {k1}; tone SNR {snr:.2f} dB over the longest active run "
          f"of {len(run) / 48_000:.2f} s [{tag}]", flush=True)
    return k1


def plain_superframe(frame_index: int, payload: bytes, n_fec: int) -> list[bytes]:
    """make_superframe written out plainly: the MetaDataFEC block, 127
    payload blocks zero-padded, the NumPy codec's parity, each behind its
    (frame, block, n_fec) header."""
    meta = struct.pack("<QIIHHII", 0, 0, 16, 128, n_fec, len(payload), zlib.crc32(payload))
    body = meta.ljust(512, b"\0") + payload.ljust(127 * 512, b"\0")
    data = np.frombuffer(body, np.uint8).reshape(128, 512)
    parity = fec.fec_encode_py(data, n_fec)
    blocks = [data[i].tobytes() for i in range(128)] + [p.tobytes() for p in parity]
    return [struct.pack("<IHH", frame_index, i, n_fec) + b for i, b in enumerate(blocks)]


def phase_codec(tag: str) -> dict:
    """11d: the native GF(256) codec against the NumPy one on one
    superframe (128 × 512 bytes, 16 parity blocks, 16 erasures), its times,
    and make_superframe's datagrams against a plain re-encode."""
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, size=(128, 512), dtype=np.uint8)
    parity = fec.fec_encode(data, DAEMON_FEC)
    check(np.array_equal(parity, fec.fec_encode_py(data, DAEMON_FEC)),
          "codec: native and NumPy parity differ")
    lost = set(rng.choice(128, size=DAEMON_FEC, replace=False).tolist())
    received = {i: data[i] for i in range(128) if i not in lost}
    received.update({128 + r: parity[r] for r in range(DAEMON_FEC)})
    native = fec.fec_decode(received, 128, 512)
    check(np.array_equal(native, data) and np.array_equal(fec.fec_decode_py(received, 128, 512),
                                                          data),
          "codec: native or NumPy recovery of 16 erasures failed")
    times = {}
    for name, fn in (("encode", lambda: fec.fec_encode(data, DAEMON_FEC)),
                     ("decode", lambda: fec.fec_decode(received, 128, 512))):
        fn()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        times[name] = (time.perf_counter() - t0) / 200 * 1e3
    payload = rng.integers(-3000, 3000, size=(16_000, 2), dtype=np.int16).tobytes()
    grams = daemon.make_superframe(5, payload, DAEMON_FEC, sample_bits=16)
    check(grams == plain_superframe(5, payload, DAEMON_FEC),
          "codec: make_superframe differs from the plain re-encode")
    print(f"phase 11d codec: native ({os.path.relpath(fec.library_path(), REPO)}) and NumPy "
          f"GF(256) agree byte for byte on 128 x 512 B with {DAEMON_FEC} parity blocks and "
          f"{DAEMON_FEC} erasures; native encode {times['encode']:.4f} ms, decode "
          f"{times['decode']:.4f} ms per superframe (host); {len(grams)} datagrams equal a "
          f"plain re-encode [{tag}]", flush=True)
    return times


# -- phase 12: RDS, network egress and ingest, reference presets, the library -------

RDS_PI = 0xD3C2
RDS_PTY = 10
RDS_PS = "SDRANGEL"
RDS_RADIOTEXT = "Broadcast FM with RDS on the card".ljust(64)
RDS_MJD, RDS_HOUR, RDS_MINUTE, RDS_TZ = 61269, 14, 30, 4  # 2026-08-17 14:30 UTC+2
RDS_CLOCK = "2026-08-17 14:30+2h"
TMC_EVENT, TMC_LOCATION = 501, 0x0C21
RDS_BLOCKS = 6
RDS_LEVEL = 0.06  # the RDS subcarrier's share of the MPX (tests/test_bfm.py's)
NET_BLOCKS = 6
TX_AF_BLOCKS = 48  # Tx blocks of 4096 AF samples: three 13,107,200-sample Rx blocks
REFPRESET = os.path.join(REPO, "tests", "goldens", "refpreset.b64")
REFPRESET_BLOCKS = 3
REFPRESET_CHANNELS = [  # tests/test_refpreset.py's channels and offsets
    (NFM, 12_500.0), (AM, -7_000.0), ("sdrangel.channel.ssbdemod", None),
    ("sdrangel.channel.wfmdemod", None), (BFM, 90_000.0), ("sdrangel.channel.dsddemod",
                                                            -250_000.0), (UDPSRC, 42_000.0)]


def rds_group_cycle() -> list[list[int]]:
    """One cycle of 22 RDS groups: 0A (PI, PTY, PS in 4 segments), 2A (the
    RadioText in 16), 4A (clock-time) and 8A (a single-group TMC event:
    roadworks, extent 4, 1 hour)."""
    groups = [[RDS_PI, (0 << 12) | (1 << 10) | (RDS_PTY << 5) | seg, 0xE0CD,
               (ord(RDS_PS[2 * seg]) << 8) | ord(RDS_PS[2 * seg + 1])] for seg in range(4)]
    groups += [[RDS_PI, (2 << 12) | (RDS_PTY << 5) | seg,
                (ord(RDS_RADIOTEXT[4 * seg]) << 8) | ord(RDS_RADIOTEXT[4 * seg + 1]),
                (ord(RDS_RADIOTEXT[4 * seg + 2]) << 8) | ord(RDS_RADIOTEXT[4 * seg + 3])]
               for seg in range(16)]
    groups.append([RDS_PI, (4 << 12) | (RDS_PTY << 5) | ((RDS_MJD >> 15) & 0x3),
                   ((RDS_MJD & 0x7FFF) << 1) | (RDS_HOUR >> 4),
                   ((RDS_HOUR & 0xF) << 12) | (RDS_MINUTE << 6) | RDS_TZ])
    groups.append([RDS_PI, (8 << 12) | (RDS_PTY << 5) | (1 << 3) | 3,
                   (1 << 15) | (1 << 14) | (4 << 11) | TMC_EVENT, TMC_LOCATION])
    return groups


def rds_bfm_blocks(dev, n_blocks: int, block: int, rate: float) -> list[np.ndarray]:
    """Phase 9d's stereo MPX (L 1 kHz, R silent, 10 % pilot sin θ, 75 kHz
    deviation) plus the RDS biphase waveform of the group cycle on the
    57 kHz subcarrier sin 3θ, coherent with the pilot (tests/test_bfm.py's
    construction); made in float64 on `dev`, int16 I/Q."""
    n_bits = int(n_blocks * block / rate * demod_bfm.RDS_SYMBOL_RATE) + 208
    cycle = np.concatenate([rds.encode_group(g) for g in rds_group_cycle()])
    wave8 = torch.from_numpy(rds.bits_to_waveform(np.resize(cycle, n_bits), sps=8)).to(
        dev, torch.float64)  # 9500 samples/s
    out, phase = [], 0.0
    for b in range(n_blocks):
        n = torch.arange(b * block, (b + 1) * block, device=dev, dtype=torch.float64)
        tt = n / rate
        left = torch.sin(2 * np.pi * 1000.0 * tt)
        theta = 2 * np.pi * 19_000.0 * tt
        mpx = (0.45 * left * (1.0 + torch.sin(2 * theta)) + 0.1 * torch.sin(theta)
               + RDS_LEVEL * wave8[(n * (9500.0 / rate)).long()] * torch.sin(3 * theta))
        ph = phase + 2 * np.pi * 75_000.0 * torch.cumsum(mpx, 0) / rate
        phase = float(ph[-1])
        iq = torch.stack([torch.cos(ph), torch.sin(ph)], -1) * (0.5 * 32768.0)
        out.append(iq.clamp(-32768, 32767).to(torch.int16).cpu().numpy())
    return out


def rds_chain(dev, cfg, blocks: list[np.ndarray]):
    """K1 ÷32 (decimate_flat_raw) and BFM with RDS on `dev`, block by block:
    yields (audio, RDS baseband) read back per block."""
    dstate = dec.init_flat_state(5, dev, raw=True)
    state = demod_bfm.make_state(cfg, dev)
    for block in blocks:
        dstate, bb = dec.decimate_flat_raw(dstate, torch.from_numpy(block).to(dev), 5)
        state, outs = demod_bfm.process(state, bb, cfg)
        yield outs.audio.cpu().numpy(), outs.rds_baseband.cpu().numpy()


def phase_rds(dev: torch.device, tag: str) -> int:
    """12a: RDS at broadcast width behind K1, the host decoder on the card's
    RDS baseband."""
    t0 = time.perf_counter()
    blocks = rds_bfm_blocks(dev, RDS_BLOCKS, SLICE_BLOCK, PRODUCT_RATE)
    gen_s = time.perf_counter() - t0
    pipe = RxPipeline(DeviceConfig(PRODUCT_RATE, log2_decim=5),
                      [ChannelSpec(BFM, 0.0, {"rds_active": True}, 180_000.0)], dev)
    cfg = pipe.demod_cfgs[0]
    check(pipe.device_block == SLICE_BLOCK and pipe.plans[0].signs == () and cfg.rds_active,
          f"rds: device block {pipe.device_block}, plan {pipe.plans[0]}")
    list(rds_chain(dev, cfg, blocks[:1]))  # warm-up
    reset_counts()
    decoder = rds.RDSDecoder(sps=8)
    audio, baseband, groups = [], [], []
    decode_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, bb in rds_chain(dev, cfg, blocks):
        audio.append(a)
        baseband.append(bb)
        t1 = time.perf_counter()
        groups += decoder.feed_baseband(bb)
        decode_s += time.perf_counter() - t1
    elapsed = time.perf_counter() - t0
    k1 = flat_decimate.launches
    check(k1 == RDS_BLOCKS, f"rds: K1 launched {k1} times for {RDS_BLOCKS} blocks")
    st = decoder.status
    events = st.tmc_events
    check(st.pi == RDS_PI and st.pty == RDS_PTY, f"rds: PI {st.pi} PTY {st.pty}")
    check(st.ps_name == RDS_PS, f"rds: PS {st.ps_name!r}")
    check(st.radiotext == RDS_RADIOTEXT, f"rds: RadioText {st.radiotext!r}")
    check(st.clock_time == RDS_CLOCK, f"rds: clock-time {st.clock_time!r}")
    want_text = rdstmc.event_text(TMC_EVENT)
    check(bool(events) and events[-1]["event"] == TMC_EVENT
          and events[-1]["event_text"] == want_text and events[-1]["location"] == TMC_LOCATION,
          f"rds: TMC events {events[-1:]}")
    decoded = 4 * st.groups_ok
    left = np.concatenate(audio)[:, 0]
    snr = tone_snr(left[len(left) // 2:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"rds: left tone SNR {snr:.1f} dB")
    t0 = time.perf_counter()
    cpu_bb = np.concatenate([bb for _, bb in rds_chain(torch.device("cpu"), cfg, blocks[:2])])
    cpu_s = time.perf_counter() - t0
    card_bb = np.concatenate(baseband[:2])
    agree = agreement_db(np.stack([cpu_bb.real, cpu_bb.imag]),
                         np.stack([card_bb.real, card_bb.imag]))
    check(agree >= 80.0, f"rds: RDS baseband card vs CPU {agree:.1f} dB")
    signal_s = RDS_BLOCKS * SLICE_BLOCK / PRODUCT_RATE
    print(f"phase 12a rds: 10 MS/s /32 stereo MPX with RDS at 57 kHz ({len(rds_group_cycle())}"
          f"-group cycle of 0A/2A/4A/8A), {RDS_BLOCKS} blocks of {SLICE_BLOCK} made on the "
          f"card in {gen_s:.2f} s (set-up); {elapsed / RDS_BLOCKS * 1e3:.3f} ms/block with the per-block "
          f"read-back and host decode, real-time factor {signal_s / elapsed:.2f}; K1 launches "
          f"{k1}; {len(groups)} groups, groups_ok {st.groups_ok}, blocks corrected "
          f"{st.blocks_corrected} ({100 * st.blocks_corrected / max(decoded, 1):.2f} % of "
          f"{decoded} decoded blocks), blocks failed {st.blocks_with_errors} "
          f"({100 * st.blocks_with_errors / max(decoded + st.blocks_with_errors, 1):.2f} %); PI "
          f"0x{st.pi:04X} PS {st.ps_name!r} RT {st.radiotext.strip()!r} CT {st.clock_time!r} "
          f"TMC {events[-1]['event']} {events[-1]['event_text']!r}; left tone SNR {snr:.2f} dB; "
          f"host decoder {decode_s / signal_s:.4f} s per second of signal; RDS baseband card vs "
          f"CPU on 2 blocks {agree:.2f} dB (CPU run {cpu_s:.1f} s) [{tag}]", flush=True)
    print(f"phase 12a rds: device time of 2 blocks by torch.profiler [{tag}]", flush=True)
    _device_time(lambda: list(rds_chain(dev, cfg, blocks[:2])), 2, elapsed / RDS_BLOCKS * 2)
    return k1


class Catcher:
    """A UDP socket on 127.0.0.1 drained by a thread while a phase runs."""

    def __init__(self, port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.datagrams: list[bytes] = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while not self._done.is_set():
            with contextlib.suppress(socket.timeout):
                self.datagrams.append(self.sock.recv(65536))

    def close(self) -> list[bytes]:
        time.sleep(0.3)  # the last datagrams of a stopped set
        self._done.set()
        self._thread.join()
        self.sock.close()
        return self.datagrams


def rtp_catchers() -> tuple[Catcher, Catcher]:
    """Catchers on a free port p (RTP) and p + 1 (its RTCP)."""
    for _ in range(50):
        rtp_c = Catcher()
        try:
            return rtp_c, Catcher(rtp_c.port + 1)
        except OSError:
            rtp_c.close()
    raise RuntimeError("no free RTP/RTCP port pair")


def serve(session: Session):
    srv = make_server(session, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def run_to_idle(base: str, what: str, index: int = 0, limit_s: float = 300.0) -> float:
    t0 = time.perf_counter()
    code, reply = http(base, f"/sdrangel/deviceset/{index}/device/run", "POST")
    check(code == 200, f"{what}: run {reply}")
    while http(base, f"/sdrangel/deviceset/{index}")[1]["state"] == "running":
        check(time.perf_counter() - t0 < limit_s, f"{what}: still running after {limit_s} s")
        time.sleep(0.01)
    _, entry = http(base, f"/sdrangel/deviceset/{index}")
    check(entry["state"] == "idle" and not entry["error"],
          f"{what}: {entry['state']} {entry['error']!r}")
    return time.perf_counter() - t0


def phase_net(path: str, tag: str) -> int:
    """12b: audio over UDP and RTP and UDPSrc's datagrams, from a cuda
    Session served in this process, the product capture played once."""
    udp_c, (rtp_c, rtcp_c), data_c = Catcher(), rtp_catchers(), Catcher()
    session = Session(device=DEVICE)
    srv, base = serve(session)
    published: list[np.ndarray] = []  # UDPSrc's I/Q of each block the set published
    publish = DeviceSet._publish_block

    def recording_publish(ds, outs, chans, egress):
        publish(ds, outs, chans, egress)
        d = next(ch.latest_data for ch in chans if ch.uri == UDPSRC)
        published.append((d["iq_real"] + 1j * d["iq_imag"]).astype(np.complex64))

    DeviceSet._publish_block = recording_publish
    try:
        code, reply = http(base, "/sdrangel/devicesets", "POST")
        check(code == 201, f"net: add device set {reply}")
        code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
            "kind": "filesource", "file_path": path, "log2_decim": 6,
            "run_blocks": NET_BLOCKS, "publish_every": 1})
        check(code == 200, f"net: device settings {reply}")
        udp_to, rtp_to = f"127.0.0.1:{udp_c.port}", f"127.0.0.1:{rtp_c.port}"
        code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
            "channelType": NFM, "inputFrequencyOffset": 20_000.0, "squelch_db": -60.0,
            "audioUdp": udp_to, "audioRtp": rtp_to})
        check(code == 201, f"net: add NFM {reply}")
        code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
            "channelType": UDPSRC, "inputFrequencyOffset": 20_000.0, "fmt": "iq",
            "udpAddress": "127.0.0.1", "udpPort": data_c.port, "udpFormat": "iq16"})
        check(code == 201, f"net: add UDPSrc {reply}")
        _, listed = http(base, "/sdrangel/audio")
        dests = [(o["kind"], o["destination"]) for o in listed["outputs"]]
        check(dests == [("udp", udp_to), ("rtp", rtp_to)], f"net: /sdrangel/audio lists {dests}")
        reset_counts()
        wall = run_to_idle(base, "net")
        k1 = flat_decimate.launches
        _, device = http(base, "/sdrangel/deviceset/0/device/report")
        code, wav_bytes = http(base, "/sdrangel/deviceset/0/channel/0/audio")
        check(code == 200, f"net: audio {wav_bytes}")
        code, data = http(base, "/sdrangel/deviceset/0/channel/1/data")
        check(code == 200, f"net: UDPSrc data {data}")
        time.sleep(0.3)  # the stopped set's last datagrams
        first = {c: len(c.datagrams) for c in (udp_c, rtp_c, rtcp_c, data_c)}
        # the same run again in this process (run_blocks counts the set's
        # blocks): the first paid for its new shapes (cuFFT plans, first
        # launches)
        code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                           {"run_blocks": 2 * NET_BLOCKS})
        check(code == 200, f"net: run_blocks {reply}")
        run_to_idle(base, "net, second run")
        _, second = http(base, "/sdrangel/deviceset/0/device/report")
    finally:
        DeviceSet._publish_block = publish
        session.shutdown()
        srv.shutdown()
        srv.server_close()
        grams = {c: c.close() for c in (udp_c, rtp_c, rtcp_c, data_c)}
    grams = {c: g[:first[c]] for c, g in grams.items()}
    check(len(published) == 2 * NET_BLOCKS,
          f"net: {len(published)} blocks published in two runs of {NET_BLOCKS}")
    check(device["blocksProcessed"] == NET_BLOCKS and k1 == NET_BLOCKS,
          f"net: K1 launched {k1} times for {device['blocksProcessed']} blocks")
    with wave.open(io.BytesIO(wav_bytes)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    got = np.concatenate([np.frombuffer(d, np.int16) for d in grams[udp_c]])
    check(got.shape == pcm.shape and int(np.abs(got.astype(np.int32) - pcm).max()) <= 1,
          f"net: UDP audio {got.shape} vs the drained audio {pcm.shape}")
    snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float64) / 32768.0, 1000.0, 48_000.0)
    check(snr > 25.0, f"net: tone SNR {snr:.1f} dB")
    pkts = [rtp.parse_packet(d) for d in grams[rtp_c]]
    check(bool(pkts) and all(p["payload_type"] == rtp.PT_L16_MONO for p in pkts)
          and all((b["seq"] - a["seq"]) & 0xFFFF == 1 for a, b in zip(pkts, pkts[1:])),
          f"net: {len(pkts)} RTP packets not L16 mono in contiguous sequence")
    rtp_pcm = np.concatenate([np.frombuffer(p["payload"], ">i2") for p in pkts]).astype(np.int16)
    check(len(rtp_pcm) == len(pcm) // 480 * 480 and np.array_equal(rtp_pcm, got[:len(rtp_pcm)]),
          f"net: RTP samples {len(rtp_pcm)} vs the UDP stream's {len(got)}")
    reports = [r for d in grams[rtcp_c] for r in rtp.parse_rtcp(d)]
    check(any(r["type"] == "SR" and r["ssrc"] == pkts[0]["ssrc"] for r in reports),
          f"net: no RTCP sender report among {[r['type'] for r in reports]}")
    iq = np.concatenate([np.frombuffer(d, np.int16) for d in grams[data_c]]).reshape(-1, 2)
    # /data holds the last block's last 2048 samples to 5 places; iq16
    # truncates as this encoding does
    tail = np.stack([data["data"]["iq_real"], data["data"]["iq_imag"]], -1)
    want = np.clip(tail * 32768.0, -32768, 32767).astype(np.int16)
    lsb = int(np.abs(iq[-len(tail):].astype(np.int32) - want).max())
    check(len(iq) % NET_BLOCKS == 0 and lsb <= 1,
          f"net: UDPSrc datagrams {len(iq)} samples, {lsb} LSB from /data")
    # every datagram of the first run: the iq16 of each block published, in
    # order, the last datagram the remainder flushed when the run stopped
    want_bytes = udp.encode_payload(np.concatenate(published[:NET_BLOCKS]), "iq16")
    check(b"".join(grams[data_c]) == want_bytes,
          f"net: UDPSrc's {len(iq)} I/Q pairs sent are not the {len(want_bytes) // 4} of the "
          f"{NET_BLOCKS} blocks published")
    n_grams = sum(len(g) for c, g in grams.items() if c is not rtcp_c)
    print(f"phase 12b net: a cuda Session over HTTP playing the product capture (/64, "
          f"{NET_BLOCKS} blocks), NFM +20 kHz with audioUdp and audioRtp and UDPSrc iq16 at "
          f"+20 kHz; K1 launches {k1}; {len(grams[udp_c])} UDP mono16 datagrams ({len(got)} "
          f"samples, within 1 LSB of the drained audio, tone SNR {snr:.2f} dB), {len(pkts)} RTP "
          f"L16 packets (seq contiguous, samples equal to the UDP stream's), {len(reports)} RTCP "
          f"reports ({sorted({r['type'] for r in reports})}), {len(grams[data_c])} UDPSrc "
          f"datagrams ({len(iq)} I/Q pairs, the iq16 of the {NET_BLOCKS} published blocks byte "
          f"for byte, the last {len(tail)} within {lsb} LSB of /data); "
          f"{n_grams / wall:.0f} datagrams/s over the {wall:.3f} s run; "
          f"{len(pcm) // NET_BLOCKS} audio samples a block; device report "
          f"{device['elapsedSeconds'] / NET_BLOCKS * 1e3:.3f} ms/block, real-time factor "
          f"{device['realtimeFactor']:.2f}; the second run in this process "
          f"{second['elapsedSeconds'] / NET_BLOCKS * 1e3:.3f} ms/block, real-time factor "
          f"{second['realtimeFactor']:.2f} [{tag}]", flush=True)
    return k1


def phase_tx_af(dev: torch.device, tag: str) -> int:
    """12c: a Tx set on the card whose AF arrives as mono16 datagrams at
    48 kHz pace; its capture decoded by RxPipeline on the card."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    stop = threading.Event()
    sent = [0]

    def sender() -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t0 = time.perf_counter()
        while not stop.is_set():
            k = sent[0]
            pcm = 0.7 * np.sin(2 * np.pi * 1000.0 * (k + np.arange(480)) / 48_000.0)
            sock.sendto((pcm * 32767).astype(np.int16).tobytes(), ("127.0.0.1", port))
            sent[0] += 480
            time.sleep(max(0.0, t0 + sent[0] / 48_000.0 - time.perf_counter()))
        sock.close()

    session = Session(device=DEVICE)
    srv, base = serve(session)
    feeder = threading.Thread(target=sender, daemon=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "afudp.sdriq")
        try:
            code, reply = http(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
            check(code == 201, f"tx af: add Tx set {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "file_path": path, "sample_rate": TX_RATE, "log2_interp": 6})
            check(code == 200, f"tx af: sink settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": NFM_MOD, "inputFrequencyOffset": 20_000.0,
                "afUdp": f"127.0.0.1:{port}"})
            check(code == 201, f"tx af: add modulator {reply}")
            t0 = time.perf_counter()
            code, reply = http(base, "/sdrangel/deviceset/0/device/run", "POST")
            check(code == 200, f"tx af: run {reply}")
            feeder.start()
            ds = session.device_sets[0]
            while ds.blocks_processed < TX_AF_BLOCKS:
                check(time.perf_counter() - t0 < 120 and not ds.error,
                      f"tx af: {ds.blocks_processed} blocks, error {ds.error!r}")
                time.sleep(0.01)
            code, _ = http(base, "/sdrangel/deviceset/0/device/run", "DELETE")
            wall = time.perf_counter() - t0
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(code == 200 and entry["state"] == "idle" and not entry["error"],
                  f"tx af: {entry['state']} {entry['error']!r}")
        finally:
            stop.set()
            session.shutdown()
            srv.shutdown()
            srv.server_close()
        feeder.join()
        info, mm = sdriq.open_mmap(path)
        pipe = RxPipeline(DeviceConfig(TX_RATE, log2_decim=6),
                          [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
        check(pipe.device_block == TX_RX_BLOCK and info.n_samples >= 3 * TX_RX_BLOCK,
              f"tx af: Rx block {pipe.device_block}, capture {info.n_samples}")
        reset_counts()
        audio = np.concatenate([o["channels"][0]["audio"] for _, o in pipe.run(
            lambda b, n: sdriq.read_block(mm, b * n, n), 3)])
        del mm
    k1 = flat_decimate.launches
    check(k1 == 3, f"tx af: K1 launched {k1} times for 3 Rx blocks")
    snr = tone_snr(audio[len(audio) // 3:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"tx af: the afUdp tone decodes at {snr:.1f} dB")
    print(f"phase 12c tx af: a Tx set on the card (NFM +20 kHz, 9.6 MS/s x64, filesink) with "
          f"afUdp fed {sent[0]} mono16 samples at 48 kHz pace; {ds.blocks_processed} blocks in "
          f"{wall:.3f} s (real-time factor {ds.blocks_processed * TX_BLOCK / TX_RATE / wall:.2f}, "
          f"paced by the sender); the capture through RxPipeline /64 on the card: K1 launches "
          f"{k1} for 3 blocks, tone SNR {snr:.2f} dB [{tag}]", flush=True)
    return k1


def phase_refpreset(tag: str) -> int:
    """12d: the reference's Base64-TLV preset in and out over HTTP, its set
    run on the card."""
    golden = refpreset.parse_preset(open(REFPRESET).read())
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "refpreset.b64"), "w") as f:
            f.write(open(REFPRESET).read())
        session = Session(device=DEVICE, preset_dir=tmp)
        srv, base = serve(session)
        try:
            code, reply = http(base, "/sdrangel/preset/file", "PUT", {"filePath": "refpreset.b64"})
            check(code == 200 and reply["imported"] == "TestGroup/Imported reference preset",
                  f"refpreset: import {reply}")
            code, reply = http(base, "/sdrangel/preset/load", "POST", {
                "groupName": "TestGroup", "name": "Imported reference preset"})
            check(code == 200, f"refpreset: load {reply}")
            _, summary = http(base, "/sdrangel")
            sets = summary["devicesetlist"]["deviceSets"]
            check(len(sets) == 1, f"refpreset: {len(sets)} device sets")
            chans = [(c["uri"], c["inputFrequencyOffset"]) for c in sets[0]["channels"]]
            check([u for u, _ in chans] == [u for u, _ in REFPRESET_CHANNELS]
                  and all(o is None or o == got for (_, o), (_, got)
                          in zip(REFPRESET_CHANNELS, chans)), f"refpreset: channels {chans}")
            src = sets[0]["source"]
            check((src["log2_decim"], src["fc_pos"], src["dc_correction"], src["sample_rate"],
                   src["center_frequency"]) == (5, "cen", True, 1_024_000.0, 145_500_000.0),
                  f"refpreset: front end {src}")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                               {"run_blocks": REFPRESET_BLOCKS})
            check(code == 200, f"refpreset: run_blocks {reply}")
            reset_counts()
            wall = run_to_idle(base, "refpreset")
            k1 = flat_decimate.launches
            _, device = http(base, "/sdrangel/deviceset/0/device/report")
            ds = session.device_sets[0]
            finite = all(bool(np.isfinite(ch.audio[-1]).all()) if ch.audio else
                         all(np.isfinite(v).all() for v in ch.latest_data.values())
                         for ch in ds.channels)
            code, reply = http(base, "/sdrangel/preset", "POST", {"groupName": "g",
                                                                 "name": "saved"})
            check(code == 200, f"refpreset: save {reply}")
            code, reply = http(base, "/sdrangel/preset/file", "POST", {
                "groupName": "g", "name": "saved", "filePath": "out.b64",
                "format": "reference"})
            check(code == 200, f"refpreset: export {reply}")
            blob = open(os.path.join(tmp, "out.b64")).read()
        finally:
            session.shutdown()
            srv.shutdown()
            srv.server_close()
    check(k1 == REFPRESET_BLOCKS and device["blocksProcessed"] == REFPRESET_BLOCKS and finite,
          f"refpreset: K1 launched {k1} times for {device['blocksProcessed']} blocks, finite "
          f"{finite}")
    back = refpreset.parse_preset(blob)
    audio_kinds = [c for c in golden["channels"][:4]]
    check(back["centerFrequency"] == golden["centerFrequency"]
          and [(c["uri"], c["settings"]) for c in back["channels"]]
          == [(c["uri"], c["settings"]) for c in audio_kinds],
          f"refpreset: the exported blob reads back as {back['channels']}")
    print(f"phase 12d refpreset: tests/goldens/refpreset.b64 imported over PUT "
          f"/sdrangel/preset/file and loaded on a cuda Session: {len(chans)} channels "
          f"({', '.join(u.rsplit('.', 1)[1] for u, _ in chans)}), front end 1.024 MS/s /32 "
          f"cen with DC correction; {REFPRESET_BLOCKS} blocks on the card, POST run to idle "
          f"{wall:.3f} s, device report {device['elapsedSeconds'] / REFPRESET_BLOCKS * 1e3:.3f} "
          f"ms/block (real-time factor {device['realtimeFactor']:.2f}), K1 launches {k1}, every "
          f"channel's output finite; exported as a reference blob of "
          f"{len(blob)} Base64 characters whose four audio channels parse back to the "
          f"golden's settings [{tag}]", flush=True)
    return k1


def phase_library(dev: torch.device, path: str, tag: str) -> dict:
    """12e: decimate_flat_iq on K1, fftcorr, and the demod CLI through the
    native .sdriq loader."""
    rng = np.random.default_rng(1212)
    out = {}
    legs, _, _ = dec._device_legs(6, "cen", dev)
    tail_len = dec.flat_tail_len(6)
    for name, size in (("gear", GEAR_BLOCK), ("product", PRODUCT_BLOCK)):
        x = torch.from_numpy(rng.uniform(-0.9, 0.9, (size, 2)).astype(np.float32)).to(dev)
        state = dec.FlatIqState(torch.from_numpy(
            rng.uniform(-0.9, 0.9, (tail_len, 2)).astype(np.float32)).to(dev))
        reset_counts()
        _, y = dec.decimate_flat_iq(state, x, 6)
        launches = flat_decimate.launches
        plain = flat_decimate_reference(x, legs, tail=state.tail)
        torch.cuda.synchronize()
        err = float((y - plain).abs().max())
        check(launches == 1 and y.shape == (size >> 6, 2) and err <= ATOL,
              f"flat_iq {name}: {launches} launches, {tuple(y.shape)}, err {err:.3e}")
        _, yc = dec.decimate_flat(dec.FlatState(torch.view_as_complex(state.tail)),
                                  torch.view_as_complex(x), 6)
        same = torch.equal(torch.view_as_real(yc), y)
        check(same, f"flat_iq {name}: differs from decimate_flat on the same samples")
        t = {"ms": time_ms(lambda: dec.decimate_flat_iq(state, x, 6)),
             "plain_ms": time_ms(lambda: flat_decimate_reference(x, legs, tail=state.tail)),
             "library_ms": time_ms(conv1d_planes(torch.cat([state.tail, x]), legs)),
             "max_abs_err": err}
        t["bound_ms"], t["bound_by"] = decimator_bound(tail_len + size, size >> 6, 64,
                                                       legs.shape[1], tensor_cores=False,
                                                       in_bytes=8)
        out[name] = t
        print(f"phase 12e flat_iq {name} block {size} f32 /64: one K1 launch, max_abs_err "
              f"{err:.3e} against its plain version, equal to decimate_flat on the same "
              f"samples as complex64 ({same}); decimate_flat_iq {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, F.conv1d {t['library_ms']:.4f} ms per block (CUDA "
              f"events); bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of it [{tag}]", flush=True)
        if name == "gear":  # three parts streamed equal one block
            third = (size // 3) & ~63
            s, parts = state, []
            for lo, hi in ((0, third), (third, 2 * third), (2 * third, size)):
                s, yp = dec.decimate_flat_iq(s, x[lo:hi], 6)
                parts.append(yp)
            check(torch.equal(torch.cat(parts), y), "flat_iq: 3 streamed parts differ")
    # fftcorr on the card against the CPU
    a = (rng.standard_normal((2, 1 << 16)) + 1j * rng.standard_normal((2, 1 << 16))
         ).astype(np.complex64)
    b = np.roll(a, 17, axis=-1)
    corr = {}
    for d in ("cpu", DEVICE):
        state = fftcorr.make_state(1024, (2,), d)
        for _ in range(2):
            state, c = fftcorr.correlate_block(state, torch.from_numpy(a).to(d),
                                               torch.from_numpy(b).to(d), 1024)
        corr[d] = c.cpu().numpy()
    rel = float(np.abs(corr[DEVICE] - corr["cpu"]).max() / np.abs(corr["cpu"]).max())
    check(rel <= 2e-5, f"fftcorr: card vs CPU {rel:.3e} relative")
    # the native loader's reads against the memmap's, then demod --in
    check(native.available(), "the native .sdriq loader did not build")
    nf = native.NativeSdriq(path)
    info, mm = sdriq.open_mmap(path)
    block, n_read = PRODUCT_BLOCK, info.n_samples // PRODUCT_BLOCK
    for k in range(n_read):
        check(np.array_equal(nf.read_i16(k * block, block),
                             sdriq.read_block(mm, k * block, block)), "native read differs")
    t0 = time.perf_counter()
    for k in range(n_read):
        nf.read_i16(k * block, block)
    read_ms = (time.perf_counter() - t0) / n_read * 1e3
    t0 = time.perf_counter()
    for k in range(n_read):
        np.array(sdriq.read_block(mm, k * block, block))
    mmap_ms = (time.perf_counter() - t0) / n_read * 1e3
    nf.close()
    del mm
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, "demod.wav")
        argv = ["demod", "--device", DEVICE, "--in", path, "--log2-decim", "6",
                "--channel", "nfm:20000", "--squelch", "-60", "--out", wav_path]
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            code = cli_main(argv)
        cli_s = time.perf_counter() - t0
        check(code == 0, f"demod --in exit {code}")
        out["cli_launches"] = flat_decimate.launches
        wav_bytes = os.path.getsize(wav_path)
    check(out["cli_launches"] == n_read,
          f"demod --in: K1 launched {out['cli_launches']} times")
    print(f"phase 12e library: fftcorr (2 x 65,536, fft 1024, 2 blocks) card vs CPU "
          f"{rel:.3e} relative; native loader built "
          f"({os.path.relpath(native.library_path(), REPO)}), {read_ms:.3f} ms per "
          f"{block}-sample block read (memmap copy {mmap_ms:.3f} ms); demod --device cuda --in "
          f"on the product capture: K1 launches {out['cli_launches']}, the WAV "
          f"({wav_bytes} bytes, {cli_s:.2f} s) [{tag}]", flush=True)
    return out


def phase_slice(dev: torch.device, product_blocks: list[np.ndarray], tag: str) -> dict:
    """Phase 12: RDS, network egress and ingest, reference presets and the
    library on the card, K1 in front of each."""
    t0 = time.perf_counter()
    launches = {"rds": phase_rds(dev, tag)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "product.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(PRODUCT_RATE))
        for b in product_blocks[:NET_BLOCKS]:
            writer.write(b)
        writer.close()
        launches["net"] = phase_net(path, tag)
        launches["tx_af_loopback"] = phase_tx_af(dev, tag)
        launches["refpreset"] = phase_refpreset(tag)
        library = phase_library(dev, path, tag)
    launches["demod_cli"] = library.pop("cli_launches")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return {"launches": launches, "flat_iq": library}


# -- phase 13: the mesh gears (parallel/mesh.py) on shards of the card ---------------

MESH_BLOCKS = 3
MESH_ATOL = 2e-5  # tests/test_sharding.py test_sharded_pfb_matches_single_device's bar


def gear_audio(step, init_fn, xs: list[torch.Tensor], args: tuple) -> tuple[np.ndarray, float]:
    """A gear over the blocks from its initial state: (audio (C, blocks·A)
    fetched, host seconds around a synchronize)."""
    state, carry = init_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = []
    for x in xs:
        state, a, carry = step(state, x, carry, *args)[:3]
        audio.append(a)
    out = torch.cat(audio, dim=-1).cpu().numpy()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def alternated(runs: dict, counter=None) -> dict:
    """Each run twice in the order a, b, b, a (after a warm-up of each on
    one block): {name: (its last audio, mean ms/block, launches per run)}."""
    (a, run_a), (b, run_b) = runs.items()
    for run in (run_a, run_b):
        run(1)
    seconds = {a: [], b: []}
    out = {}
    for name in (a, b, b, a):
        if counter is not None:
            counter.launches = 0
        audio, elapsed = runs[name](MESH_BLOCKS)
        seconds[name].append(elapsed)
        out[name] = (audio, None if counter is None else counter.launches)
    return {k: (out[k][0], sum(v) / len(v) / MESH_BLOCKS * 1e3, out[k][1])
            for k, v in seconds.items()}


def block_errors(want: np.ndarray, got: np.ndarray) -> list[float]:
    per = want.shape[-1] // MESH_BLOCKS
    return [float(np.abs(want[:, i * per:(i + 1) * per] - got[:, i * per:(i + 1) * per]).max())
            for i in range(MESH_BLOCKS)]


def block_agreement(want: np.ndarray, got: np.ndarray) -> list[float]:
    """Per block, the bank's audio agreement in dB (`agreement_db`)."""
    per = want.shape[-1] // MESH_BLOCKS
    return [agreement_db(want[:, i * per:(i + 1) * per], got[:, i * per:(i + 1) * per])
            for i in range(MESH_BLOCKS)]


def shifted_down(x: torch.Tensor, r: int) -> torch.Tensor:
    """The int16 capture x·e^{−j2πn/r} (its spectrum moved down by fs/r),
    requantized: at ÷64 the inf placement's passband is centred on −fs/64."""
    n = torch.arange(x.shape[0], device=x.device) % r
    rot = torch.polar(torch.ones(r, device=x.device), -2 * np.pi / r * torch.arange(
        r, device=x.device, dtype=torch.float32))[n]
    y = torch.view_as_real(torch.complex(x[:, 0].float(), x[:, 1].float()) * rot)
    return torch.round(y).clamp(-32768, 32767).to(torch.int16)


def pcm_agrees(pcm: np.ndarray, audio: np.ndarray, tol: float = 1e-6) -> bool:
    """The WAV's int16 samples are what the session's float audio quantizes
    to if it lies within `tol` of `audio` (the route's rounding)."""
    def q(a):
        return np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
    lo, hi = q(audio - tol), q(audio + tol)
    return pcm.shape == audio.shape and bool(np.all((pcm >= lo) & (pcm <= hi)))


def phase_mesh(dev: torch.device, xs: list[torch.Tensor], tag: str) -> dict:
    """Phase 13: 13a the all-gather gear on 2×2 and 2×1 (inf) meshes of
    shards of the card, each against the 1×1 gear and against the same mesh
    with the kernel's plain version, 13b the all-to-all gear at 2×2 and
    bench.py's chain64a2a, 13c the sharded session through the `server`
    CLI."""
    t_phase = time.perf_counter()
    cfg1 = chainsharded_config()
    offs = chainsharded_offsets(cfg1)
    idx, res = sharded.grid_split(cfg1, offs)
    args = (torch.from_numpy(res).to(dev), torch.from_numpy(idx).to(dev))
    tone_demods = (5, 6)  # phase 5's carriers
    launches = {}
    ms = {}

    def runner(cfg, mesh, blocks, step_args):
        step, init_fn = sharded.build_sharded_step(cfg, mesh)
        return lambda n: gear_audio(step, init_fn, blocks[:n], step_args)

    # 13a: 2×2 against 1×1, K1-TC on every shard; then against the same
    # mesh with K1-TC's plain version (its 2^24-sample shards and halos)
    cfg4 = dataclasses.replace(cfg1, n_time=2, n_channel=2)
    out = alternated({"1x1": runner(cfg1, dev, xs, args),
                      "2x2": runner(cfg4, make_mesh(2, 2, [dev] * 4), xs, args)},
                     counter=flat_decimate_tc)
    one, ms["13a 1x1"], _ = out["1x1"]
    four, ms["13a 2x2"], launches["13a_2x2"] = out["2x2"]
    with plain_tc_decimator():
        plain4, _ = runner(cfg4, make_mesh(2, 2, [dev] * 4), xs, args)(MESH_BLOCKS)
    errs = block_errors(one, four)
    agree4 = block_agreement(plain4, four)
    snrs = [tone_snr(four[k, four.shape[1] // 2:].astype(np.float64), 1000.0, 48_000.0)
            for k in tone_demods]
    check(bool(np.isfinite(four).all()) and max(errs) <= MESH_ATOL,
          f"13a: 2x2 against 1x1 per block {errs}")
    check(min(agree4) >= 80.0, f"13a: 2x2 against its plain-K1-TC run per block {agree4} dB")
    check(launches["13a_2x2"] == 4 * MESH_BLOCKS > 0,
          f"13a: K1-TC launched {launches['13a_2x2']} times, 4 shards x {MESH_BLOCKS}")
    check(min(snrs) > 25.0, f"13a: tone SNR {snrs} dB")
    print(f"phase 13a mesh: chainsharded on a 2x2 mesh of four shards of {dev}: max |d| per "
          f"block against the 1x1 gear {[f'{e:.2e}' for e in errs]} (bar {MESH_ATOL}); "
          f"against the same mesh with K1-TC's plain version {[f'{a:.2f}' for a in agree4]} dB "
          f"per block (bar 80), max |d| {[f'{e:.2e}' for e in block_errors(plain4, four)]}; "
          f"K1-TC {launches['13a_2x2']} launches in {MESH_BLOCKS} blocks (one per shard and "
          f"block); tone SNR {snrs[0]:.2f} / {snrs[1]:.2f} dB (demods {tone_demods}); "
          f"{ms['13a 2x2']:.3f} ms/block against the 1x1 gear's {ms['13a 1x1']:.3f}, mean of 2 "
          f"runs each, order 1x1, 2x2, 2x2, 1x1 [{tag}]", flush=True)
    del plain4

    # 13a: a 2×1 mesh at fc_pos=inf, K1's complex legs on each time shard;
    # then against the same mesh with K1's plain version
    inf = [shifted_down(x, 1 << cfg1.log2_decim) for x in xs]
    cfg_inf = dataclasses.replace(cfg1, fc_pos="inf")
    cfg_inf2 = dataclasses.replace(cfg_inf, n_time=2)
    out = alternated({"1x1": runner(cfg_inf, dev, inf, args),
                      "2x1": runner(cfg_inf2, make_mesh(2, 1, [dev] * 2), inf, args)},
                     counter=flat_decimate)
    one_inf, ms["13a inf 1x1"], _ = out["1x1"]
    two_inf, ms["13a inf 2x1"], launches["13a_2x1_inf"] = out["2x1"]
    with plain_decimator():
        plain_inf, _ = runner(cfg_inf2, make_mesh(2, 1, [dev] * 2), inf, args)(MESH_BLOCKS)
    errs_inf = block_errors(one_inf, two_inf)
    agree_inf = block_agreement(plain_inf, two_inf)
    snrs_inf = [tone_snr(two_inf[k, two_inf.shape[1] // 2:].astype(np.float64), 1000.0,
                         48_000.0) for k in tone_demods]
    check(max(errs_inf) <= MESH_ATOL, f"13a inf: 2x1 against 1x1 per block {errs_inf}")
    check(min(agree_inf) >= 80.0,
          f"13a inf: 2x1 against its plain-K1 run per block {agree_inf} dB")
    check(launches["13a_2x1_inf"] == 2 * MESH_BLOCKS > 0,
          f"13a inf: K1 launched {launches['13a_2x1_inf']} times")
    check(min(snrs_inf) > 25.0, f"13a inf: tone SNR {snrs_inf} dB")
    print(f"phase 13a mesh: the capture moved down by fs/64 (the inf passband) at fc_pos=inf on "
          f"a 2x1 mesh: max |d| per block against the 1x1 gear "
          f"{[f'{e:.2e}' for e in errs_inf]}; against the same mesh with K1's plain version "
          f"{[f'{a:.2f}' for a in agree_inf]} dB per block (bar 80), max |d| "
          f"{[f'{e:.2e}' for e in block_errors(plain_inf, two_inf)]}; K1 (complex legs) "
          f"{launches['13a_2x1_inf']} launches; tone SNR {snrs_inf[0]:.2f} / "
          f"{snrs_inf[1]:.2f} dB; {ms['13a inf 2x1']:.3f} ms/block against "
          f"{ms['13a inf 1x1']:.3f} [{tag}]", flush=True)
    del inf, plain_inf

    # 13b: the all-to-all gear at 13a's 2×2 width, four demods on each grid
    # channel (so every shard's grid chunk holds four), against the all-gather gear
    # (phase 5's residual of demod k is offs[k] − (k mod 4 − 1.5)·2·grid)
    grid = cfg1.baseband_rate / cfg1.pfb_m
    offs_b = np.array([(0, 1, 2, -1)[k % 4] * grid + (offs[k] - (k % 4 - 1.5) * 2 * grid)
                       for k in range(16)])
    cfg4a = dataclasses.replace(cfg4, pfb_all_to_all=True)
    orders, local_idx, residuals = sharded.a2a_placement(cfg4a, [offs_b])
    idx_b, res_b = sharded.grid_split(cfg4, offs_b)
    mesh4 = make_mesh(2, 2, [dev] * 4)
    out = alternated({
        "all-gather": runner(cfg4, mesh4, xs, (torch.from_numpy(res_b).to(dev),
                                               torch.from_numpy(idx_b).to(dev))),
        "a2a": runner(cfg4a, mesh4, xs, (torch.from_numpy(residuals[0]).to(dev),
                                         torch.from_numpy(local_idx[0]).to(dev)))},
        counter=flat_decimate_tc)
    gathered, ms["13b all-gather 2x2"], _ = out["all-gather"]
    swapped, ms["13b a2a 2x2"], launches["13b_a2a_2x2"] = out["a2a"]
    unperm = np.empty_like(swapped)
    unperm[orders[0]] = swapped
    errs_a = block_errors(gathered, unperm)
    carrier_demods = [k for k in range(16) if abs(offs_b[k] - offs[5]) < 1.0
                      or abs(offs_b[k] - offs[6]) < 1.0]
    snrs_a = [tone_snr(unperm[k, unperm.shape[1] // 2:].astype(np.float64), 1000.0, 48_000.0)
              for k in carrier_demods]
    check(max(errs_a) <= MESH_ATOL and min(snrs_a) > 25.0,
          f"13b: a2a against all-gather per block {errs_a}, tone SNR {snrs_a}")
    check(launches["13b_a2a_2x2"] == 4 * MESH_BLOCKS, f"13b: K1-TC {launches['13b_a2a_2x2']}")
    print(f"phase 13b mesh: the all-to-all gear on the 2x2 mesh (4 NFM on each of the 4 grid "
          f"channels, one grid channel per shard) against the all-gather gear: max |d| per "
          f"block {[f'{e:.2e}' for e in errs_a]}; tone SNR {min(snrs_a):.2f} dB at the "
          f"carriers' demods {carrier_demods}; K1-TC {launches['13b_a2a_2x2']} launches; "
          f"{ms['13b a2a 2x2']:.3f} ms/block against {ms['13b all-gather 2x2']:.3f} [{tag}]",
          flush=True)

    # 13b: bench.py's chain64a2a on a 1×1 mesh: ÷1, PFB-256, 64 NFM over
    # 64 slots (bench.py:176-180), the bench's uniform int16 input
    cfg64 = sharded.ShardedPipelineConfig(
        n_time=1, n_channel=1, device_rate=GEAR_RATE, log2_decim=0, block=GEAR_BLOCK,
        pfb_m=256, pfb_all_to_all=True, bank=(sharded.BankGroup(NFM, 64, {
            "squelch_db": -100.0, "squelch_gate_ms": 1.0}),))
    slots = np.array([c if c < 32 else c - 64 for c in range(64)])
    offs64 = slots * (GEAR_RATE / 256) + np.linspace(-4000.0, 4000.0, 64)
    orders64, local64, res64 = sharded.a2a_placement(cfg64, [offs64])
    cfg64g = dataclasses.replace(cfg64, pfb_all_to_all=False)
    idx64, res64g = sharded.grid_split(cfg64g, offs64)
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = [torch.randint(-2048, 2048, (GEAR_BLOCK, 2), generator=gen, device=dev,
                           dtype=torch.int16) for _ in range(MESH_BLOCKS)]
    out = alternated({
        "all-gather": runner(cfg64g, dev, noise, (torch.from_numpy(res64g).to(dev),
                                                  torch.from_numpy(idx64).to(dev))),
        "a2a": runner(cfg64, dev, noise, (torch.from_numpy(res64[0]).to(dev),
                                          torch.from_numpy(local64[0]).to(dev)))})
    g64, ms["13b chain64 all-gather 1x1"], _ = out["all-gather"]
    a64, ms["13b chain64a2a 1x1"], _ = out["a2a"]
    un64 = np.empty_like(a64)
    un64[orders64[0]] = a64
    errs64 = block_errors(g64, un64)
    check(bool(np.isfinite(a64).all()) and np.abs(a64).max() > 0.01 and max(errs64) <= MESH_ATOL,
          f"13b chain64a2a: against the all-gather gear per block {errs64}")
    print(f"phase 13b mesh: chain64a2a (12.288 MS/s, /1, PFB-256, 64 NFM over 64 slots, "
          f"2^25-sample blocks of uniform int16 in [-2048, 2048) from seed 7) on a 1x1 mesh: "
          f"max |d| per block against the all-gather gear's same 64 channels "
          f"{[f'{e:.2e}' for e in errs64]}; {ms['13b chain64a2a 1x1']:.3f} ms/block against "
          f"{ms['13b chain64 all-gather 1x1']:.3f} [{tag}]", flush=True)
    del noise

    # 13c: the sharded session through the server CLI, 13a's capture as a .sdriq
    step_a, init_a = sharded.build_sharded_step(
        dataclasses.replace(cfg1, pfb_all_to_all=True), dev)
    orders_c, local_c, res_c = sharded.a2a_placement(
        dataclasses.replace(cfg1, pfb_all_to_all=True), [offs])
    direct_a2a, _ = gear_audio(step_a, init_a, xs, (torch.from_numpy(res_c[0]).to(dev),
                                                    torch.from_numpy(local_c[0]).to(dev)))
    direct = {"pfb": one, "a2a": np.empty_like(direct_a2a)}
    direct["a2a"][orders_c[0]] = direct_a2a
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gear.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(GEAR_RATE))
        for x in xs:
            writer.write(x.cpu().numpy())
        writer.close()
        with server_process(tmp, "13c sharded server") as (base, logs):
            check(http(base, "/sdrangel/devicesets", "POST")[0] == 201, "13c: add set")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "kind": "filesource", "file_path": path, "log2_decim": 6, "sharded": True,
                "sharded_pfb_m": 4, "sharded_block": GEAR_BLOCK, "run_blocks": MESH_BLOCKS})
            check(code == 200, f"13c: device settings {reply}")
            for off in offs:
                code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                    "channelType": NFM, "inputFrequencyOffset": float(off),
                    "squelch_db": -100.0, "squelch_gate_ms": 1.0})
                check(code == 201, f"13c: add channel {reply}")
            for gear in ("pfb", "a2a"):
                if gear == "a2a":
                    code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                                       {"sharded_pfb_a2a": True})
                    check(code == 200, f"13c: a2a {reply}")
                wall = run_to_idle(base, f"13c {gear}")
                _, device = http(base, "/sdrangel/deviceset/0/device/report")
                _, summary = http(base, "/sdrangel")
                entry = summary["devicesetlist"]["deviceSets"][0]
                pcm = []
                for j in range(16):
                    code, wav_bytes = http(base, f"/sdrangel/deviceset/0/channel/{j}/audio")
                    check(code == 200, f"13c {gear}: audio {j}")
                    with wave.open(io.BytesIO(wav_bytes)) as w:
                        pcm.append(np.frombuffer(w.readframes(w.getnframes()), np.int16))
                pcm = np.stack(pcm)
                runs = 1 + (gear == "a2a")  # the count goes on across runs
                check(device["blocksProcessed"] == runs * MESH_BLOCKS and not entry["a2aFallback"]
                      and pcm_agrees(pcm, direct[gear]),
                      f"13c {gear}: {device} {entry['a2aFallback']} pcm {pcm.shape} "
                      f"{logs[-1][-2000:] if logs else ''}")
                reports[gear] = {"realtimeFactor": device["realtimeFactor"],
                                 "elapsedSeconds": device["elapsedSeconds"],
                                 "a2aFallback": entry["a2aFallback"], "wall_s": wall}
                print(f"phase 13c mesh: python -m sdrangel_tpu_torch server --device {DEVICE}, "
                      f"sharded {'PFB-4 all-gather' if gear == 'pfb' else 'PFB-4 all-to-all'} "
                      f"gear on a 1x1 mesh of the card, 13a's capture from a .sdriq, "
                      f"{MESH_BLOCKS} blocks: realtimeFactor {device['realtimeFactor']:.3f}, "
                      f"{device['elapsedSeconds'] / MESH_BLOCKS * 1e3:.3f} ms/block (device "
                      f"report, the process's {'first' if gear == 'pfb' else 'second'} run), "
                      f"a2aFallback {entry['a2aFallback']}; the 16 channels' WAV equal to the "
                      f"direct step's audio within 1e-6 as 16-bit PCM shows it [{tag}]",
                      flush=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    return {"launches": launches, "ms": ms, "session": reports}


# -- phase 14: the capture formats, the corrections and inf/sup at the product
#    block, and the gear at sup and with chan_stages -----------------------------

FORMAT_BLOCKS = 4
FORMAT_CPU_BLOCKS = 2
#: (name, DeviceConfig fields, the K1 form its path launches); every one of
#: them leaves the fused i16 ingest for the non-fused branch of RxPipeline.step
FORMAT_CONFIGS = (
    ("u8", {"input_format": "u8"}, "f32 real"),  # RTL-SDR
    ("i8", {"input_format": "i8"}, "f32 real"),  # HackRF
    ("i12", {"input_format": "i12"}, "f32 real"),  # Airspy, PlutoSDR
    ("i24", {"input_format": "i24"}, "f32 real"),  # 24-bit .sdriq
    ("i16 dc_iq", {"dc_correction": True, "iq_correction": True}, "f32 real"),
    ("i16 inf", {"fc_pos": "inf"}, "f32 complex"),
    ("i16 sup", {"fc_pos": "sup"}, "f32 complex"),
)
#: the front end's faults for the corrections to remove: DC on I, I's gain
#: and Q leaking into I (testsource's impairments), each 5 % of full scale
IMPAIRMENTS = {"dc_factor": 0.05, "i_factor": 0.05, "phase_imbalance": 0.05}
CHAN_STAGES = 2  # bench.py -t chain's depth: a 48 kHz channel of the 192 kHz baseband


def placement_centre(log2_decim: int, fc_pos: str, rate: float) -> float:
    """The centre (Hz) of the band that a placement brings to DC, read off
    decimators.placement_schedule: stage m's ±fs/4 rotation, pulled to the
    input, moves the spectrum by s_m·rate/2^(m+2), and the band at minus
    their sum lands at DC."""
    signs = dec.placement_schedule(log2_decim, fc_pos)
    return -sum(s * rate / (4 << m) for m, s in enumerate(signs))


def card_fm(dev: torch.device, block: int, index: int, rate: float, carrier: float,
            amplitude: float = 0.5, dc_factor: float = 0.0, i_factor: float = 0.0,
            phase_imbalance: float = 0.0) -> torch.Tensor:
    """Block `index` of testsource's FM (1 kHz tone, 5 kHz deviation) at
    `carrier`, its impairments included, made on the card in float64:
    (block,) complex128."""
    t = (index * block + torch.arange(block, dtype=torch.float64, device=dev)) / rate
    phase = 2 * np.pi * carrier * t - 5000.0 / 1000.0 * torch.cos(2 * np.pi * 1000.0 * t)
    re = torch.cos(phase) * amplitude * (1.0 + i_factor)
    im = torch.sin(phase) * amplitude + phase_imbalance * re
    return torch.complex(re + dc_factor * amplitude, im)


def rotated(x: torch.Tensor, freq: float, rate: float, start: int) -> torch.Tensor:
    """The int16 capture block x (samples from `start` of the stream) moved
    by `freq` Hz, requantized: x·e^{j2π·freq·n/rate}, the phase in float64."""
    n = start + torch.arange(x.shape[0], dtype=torch.float64, device=x.device)
    turns = torch.remainder(n * (freq / rate), 1.0)
    c = torch.complex(x[:, 0].double(), x[:, 1].double()) / 32768.0
    return complex_to_iq_raw(c * torch.polar(torch.ones_like(turns), 2 * np.pi * turns), "i16")


def reset_k1_counts() -> None:
    reset_counts()
    flat_decimate.form_launches = dict.fromkeys(k1_kernel.FORMS, 0)


def upload_ms(pipe: RxPipeline, blocks: list[np.ndarray]) -> list[float]:
    """Mean host ms of `RxPipeline.upload` a block (a pinned copy, the H2D),
    synchronized after each of two passes over the blocks: a pass that
    needs more pinned buffers of the block's size than the caching host
    allocator holds pays for their allocation."""
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in blocks:
            pipe.upload(b)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / len(blocks) * 1e3)
    return out


def phase_formats(dev: torch.device, product_blocks: list[np.ndarray], tag: str) -> dict:
    """14a: RxPipeline on the card at 10 MS/s ÷64 NFM +20 kHz, phase 3's FM
    signal quantized to each capture format, corrected, or moved into the
    inf/sup passband; each against the CPU pipeline."""
    chans = [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})]
    first = complex_to_iq_raw(card_fm(dev, PRODUCT_BLOCK, 0, PRODUCT_RATE, 20_000.0), "i16")
    lsb = int((first.int() - torch.from_numpy(product_blocks[0]).to(dev).int()).abs().max())
    check(lsb <= 1, f"14a: the card's FM is {lsb} LSB from phase 3's block 0")
    out = {"launches": {}, "ms": {}, "upload_ms": {}, "audio": {}, "blocks": {}}
    for name, fields, form in FORMAT_CONFIGS:
        fmt, fc_pos = fields.get("input_format", "i16"), fields.get("fc_pos", "cen")
        carrier = 20_000.0
        if fc_pos != "cen":
            centre = placement_centre(6, fc_pos, PRODUCT_RATE)
            check(centre == {"inf": -1, "sup": 1}[fc_pos] * PRODUCT_RATE / 64,
                  f"14a {name}: the placement's centre {centre} Hz is not ∓fs/64")
            carrier += centre
        impair = IMPAIRMENTS if fields.get("dc_correction") else {}
        t0 = time.perf_counter()
        blocks = [complex_to_iq_raw(card_fm(dev, PRODUCT_BLOCK, b, PRODUCT_RATE, carrier,
                                            **impair), fmt).cpu().numpy()
                  for b in range(FORMAT_BLOCKS)]
        made_s = time.perf_counter() - t0
        cfg = DeviceConfig(PRODUCT_RATE, log2_decim=6, **fields)
        pipe = RxPipeline(cfg, chans, dev)
        check(pipe.device_block == PRODUCT_BLOCK and not pipe.fused_ingest,
              f"14a {name}: block {pipe.device_block}, fused {pipe.fused_ingest}")
        list(pipe.run(lambda b, n: blocks[b], 1))  # warm-up: this configuration's shapes
        reset_k1_counts()
        audio, elapsed = run_product(pipe, blocks)
        launches, total = dict(flat_decimate.form_launches), flat_decimate.launches
        check(launches[form] == FORMAT_BLOCKS == total and flat_decimate_tc.launches == 0,
              f"14a {name}: K1 launches by form {launches}, K1-TC {flat_decimate_tc.launches}, "
              f"for {FORMAT_BLOCKS} blocks")
        per_block = pipe.demod_cfgs[0].resampler_plan.block_out
        check(audio.shape == (FORMAT_BLOCKS * per_block,) and bool(np.isfinite(audio).all()),
              f"14a {name}: audio {audio.shape}")
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
        check(snr > 25.0, f"14a {name}: tone SNR {snr:.1f} dB")
        up_ms = upload_ms(pipe, blocks)  # before the CPU run, whose threads share the host
        cpu_pipe = RxPipeline(cfg, chans, "cpu")
        t0 = time.perf_counter()
        cpu_audio = np.concatenate([o["channels"][0]["audio"] for _, o in cpu_pipe.run(
            lambda b, n: blocks[b], FORMAT_CPU_BLOCKS)])
        cpu_s = time.perf_counter() - t0
        cpu_agree = agreement_db(cpu_audio, audio[:FORMAT_CPU_BLOCKS * per_block])
        check(cpu_agree >= 80.0, f"14a {name}: card vs CPU pipeline {cpu_agree:.1f} dB")
        ms = elapsed / FORMAT_BLOCKS * 1e3
        out["launches"][name], out["ms"][name], out["upload_ms"][name] = launches[form], ms, up_ms
        out["audio"][name], out["blocks"][name] = audio, blocks
        print(f"phase 14a formats ({name}): 10 MS/s {fmt} ({blocks[0].dtype}, "
              f"{blocks[0].nbytes / 1e6:.1f} MB a block) /64 {fc_pos}"
              f"{' DC+IQ corrected' if impair else ''}, NFM +20 kHz, carrier {carrier:.1f} Hz: "
              f"{FORMAT_BLOCKS} blocks of {PRODUCT_BLOCK} at {ms:.3f} ms/block (host clock "
              f"around a synchronize, upload included, after 1 warm-up block), real-time factor "
              f"{PRODUCT_BLOCK / PRODUCT_RATE / (ms / 1e3):.2f}; the upload alone "
              f"{up_ms[0]:.3f} / {up_ms[1]:.3f} ms/block (two passes); K1 {form} {launches[form]} launches of {total} "
              f"(by form {launches}); tone SNR {snr:.2f} dB; card vs CPU pipeline on "
              f"{FORMAT_CPU_BLOCKS} blocks {cpu_agree:.2f} dB (CPU run {cpu_s:.1f} s); blocks "
              f"made on the card in {made_s:.2f} s (set-up) [{tag}]", flush=True)
    return out


def phase_format_sessions(dev: torch.device, formats: dict, tag: str) -> dict:
    """14b: raw cu8 and cs8 captures and a 24-bit .sdriq (streamed and
    preloaded) through a cuda Session over HTTP, then `demod --in` on a 24-bit
    capture at fc_pos inf with IQ correction."""
    launches = {}
    session = Session(device=DEVICE)
    srv, base = serve(session)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths = {}
            for ext, name in (("cu8", "u8"), ("cs8", "i8")):
                paths[ext] = os.path.join(tmp, f"capture.{ext}")
                with open(paths[ext], "wb") as f:
                    for b in formats["blocks"][name]:
                        f.write(b.tobytes())
            paths["sdriq24"] = os.path.join(tmp, "capture24.sdriq")
            writer = sdriq.SdriqWriter(paths["sdriq24"], sample_rate=int(PRODUCT_RATE),
                                       sample_size=24)
            for b in formats["blocks"]["i24"]:
                writer.write(b)
            writer.close()
            pcm_by_run = {}
            runs = (("cu8", "u8", False), ("cs8", "i8", False), ("sdriq24", "i24", False),
                    ("sdriq24", "i24", True))
            for i, (kind, name, preload) in enumerate(runs):
                what = f"14b {kind}{' preloaded' if preload else ''}"
                code, reply = http(base, "/sdrangel/devicesets", "POST")
                check(code == 201 and reply["index"] == i, f"{what}: add device set {reply}")
                settings = {"kind": "filesource", "file_path": paths[kind], "log2_decim": 6,
                            "run_blocks": FORMAT_BLOCKS, "publish_every": 1,
                            "file_preload": preload}
                if kind != "sdriq24":  # a raw capture has no header: its rate is a setting
                    settings["sample_rate"] = PRODUCT_RATE
                code, reply = http(base, f"/sdrangel/deviceset/{i}/device/settings", "PATCH",
                                   settings)
                check(code == 200, f"{what}: device settings {reply}")
                code, reply = http(base, f"/sdrangel/deviceset/{i}/channel", "POST", {
                    "channelType": NFM, "inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})
                check(code == 201, f"{what}: add channel {reply}")
                reset_k1_counts()
                wall = run_to_idle(base, what, i)
                form_launches = dict(flat_decimate.form_launches)
                _, device = http(base, f"/sdrangel/deviceset/{i}/device/report")
                code, data = http(base, f"/sdrangel/deviceset/{i}/channel/0/audio")
                check(code == 200, f"{what}: audio {data}")
                with wave.open(io.BytesIO(data)) as w:
                    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                ref = formats["audio"][name]
                check(device["blocksProcessed"] == FORMAT_BLOCKS
                      and form_launches["f32 real"] == FORMAT_BLOCKS == flat_decimate.launches,
                      f"{what}: {device['blocksProcessed']} blocks, K1 by form {form_launches}")
                check(pcm_agrees(pcm, ref), f"{what}: the WAV ({pcm.shape}) is not RxPipeline"
                      f".run's audio ({ref.shape}) as 16-bit PCM shows it")
                pcm_by_run[what] = pcm
                launches[what.split(" ", 1)[1]] = form_launches["f32 real"]
                print(f"phase 14b sessions ({what[4:]}): {FORMAT_BLOCKS} blocks of "
                      f"{PRODUCT_BLOCK} ({name}) through a cuda Session over HTTP (the "
                      f"Session's run {i + 1}), "
                      f"{device['elapsedSeconds'] / FORMAT_BLOCKS * 1e3:.3f} ms/block (device "
                      f"report), real-time factor {device['realtimeFactor']:.2f}, POST run to "
                      f"idle {wall:.3f} s; K1 f32 real {form_launches['f32 real']} launches; the "
                      f"WAV equal to RxPipeline.run's audio within 1e-6 as 16-bit PCM shows it, "
                      f"{int(np.sum(pcm != np.clip(ref * 32768.0, -32768, 32767).astype(np.int16)))}"
                      f" of {pcm.size} samples a code apart [{tag}]", flush=True)
            equal = np.array_equal(pcm_by_run["14b sdriq24"], pcm_by_run["14b sdriq24 preloaded"])
            check(equal, "14b: the preloaded 24-bit audio differs from the streamed")

            # demod --in on a 24-bit capture of the inf signal, IQ correction on
            fields = {"fc_pos": "inf", "iq_correction": True, "input_format": "i24"}
            carrier = 20_000.0 + placement_centre(6, "inf", PRODUCT_RATE)
            blocks = [complex_to_iq_raw(card_fm(dev, PRODUCT_BLOCK, b, PRODUCT_RATE, carrier,
                                                **IMPAIRMENTS), "i24").cpu().numpy()
                      for b in range(FORMAT_BLOCKS)]
            path = os.path.join(tmp, "inf24.sdriq")
            writer = sdriq.SdriqWriter(path, sample_rate=int(PRODUCT_RATE), sample_size=24)
            for b in blocks:
                writer.write(b)
            writer.close()
            pipe = RxPipeline(DeviceConfig(PRODUCT_RATE, log2_decim=6, **fields),
                              [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
            ref, _ = run_product(pipe, blocks)
            wav_path = os.path.join(tmp, "inf24.wav")
            reset_k1_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                code = cli_main(["demod", "--device", DEVICE, "--in", path, "--log2-decim", "6",
                                 "--fc-pos", "inf", "--iq-correction", "--channel", "nfm:20000",
                                 "--squelch", "-60", "--out", wav_path])
            cli_s = time.perf_counter() - t0
            cli = dict(flat_decimate.form_launches)
            check(code == 0, f"14b demod --in: exit {code}")
            data, fs = wav.read_wav(wav_path)
            pcm = data[:, 0]
            snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float64) / 32768.0, 1000.0, fs)
            exact = np.array_equal(pcm, np.clip(ref * 32768.0, -32768, 32767).astype(np.int16))
            check(cli["f32 complex"] == FORMAT_BLOCKS == flat_decimate.launches,
                  f"14b demod --in: K1 by form {cli}")
            check(pcm_agrees(pcm, ref) and snr > 25.0,
                  f"14b demod --in: the WAV against RxPipeline.run, tone SNR {snr:.1f} dB")
            launches["demod --in inf24 iq"] = cli["f32 complex"]
            print(f"phase 14b sessions: preloaded 24-bit audio equals the streamed bit for bit "
                  f"({equal}); demod --device {DEVICE} --in on a 24-bit .sdriq of the signal at "
                  f"{carrier:.1f} Hz, --fc-pos inf --iq-correction: exit 0 in {cli_s:.2f} s "
                  f"in-process, K1 f32 complex {cli['f32 complex']} launches, tone SNR "
                  f"{snr:.2f} dB, the WAV equal to RxPipeline.run's audio as 16-bit PCM "
                  f"({'bit for bit' if exact else 'within 1e-6'}) [{tag}]", flush=True)
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    return launches


def phase_gear_forms(dev: torch.device, xs: list[torch.Tensor], tag: str) -> dict:
    """14c: phase 5's gear on a 1×1 mesh at fc_pos=sup (K1's complex legs)
    and with chan_stages (K1-TC), each against the same gear on the
    kernel's plain version, over phase 5's blocks moved on the card."""
    cfg1 = chainsharded_config()
    offs = chainsharded_offsets(cfg1)
    idx, res = sharded.grid_split(cfg1, offs)
    grid = cfg1.baseband_rate / cfg1.pfb_m
    centre = placement_centre(cfg1.log2_decim, "sup", cfg1.device_rate)
    check(centre == cfg1.device_rate / 64, f"14c: the sup centre {centre} Hz is not fs/64")
    # chan_stages keeps the centre 48 kHz: demod 6's PFB channel (its
    # carrier at its residual, −1,440 Hz) moved to DC, every offset with it
    shift = -(6 % 4 - 1.5) * 2 * grid
    forms = {
        "sup": (dataclasses.replace(cfg1, fc_pos="sup"), centre,
                (torch.from_numpy(res).to(dev), torch.from_numpy(idx).to(dev)),
                flat_decimate, plain_decimator, (5, 6)),
        "chan_stages": (dataclasses.replace(cfg1, pfb_m=0, chan_stages=CHAN_STAGES), shift,
                        (torch.from_numpy((offs + shift).astype(np.float32)).to(dev),),
                        flat_decimate_tc, plain_tc_decimator, (6,)),
    }
    out = {"launches": {}, "ms": {}}
    for name, (cfg, freq, args, counter, plain, tone_demods) in forms.items():
        moved = [rotated(x, freq, GEAR_RATE, b * GEAR_BLOCK) for b, x in enumerate(xs)]
        step, init_fn = sharded.build_sharded_step(cfg, dev)
        gear_audio(step, init_fn, moved[:1], args)  # warm-up
        with plain():
            gear_audio(step, init_fn, moved[:1], args)
        reset_k1_counts()
        audio, elapsed = gear_audio(step, init_fn, moved, args)
        launches = counter.launches
        complex_legs = flat_decimate.form_launches["f32 complex"]
        with plain():
            plain_audio, plain_s = gear_audio(step, init_fn, moved, args)
        check(launches == MESH_BLOCKS and (name != "sup" or complex_legs == MESH_BLOCKS),
              f"14c {name}: {launches} launches of {counter.__name__} ({complex_legs} of "
              f"K1's complex legs) in {MESH_BLOCKS} blocks")
        check(audio.shape[0] == 16 and bool(np.isfinite(audio).all()),
              f"14c {name}: audio {audio.shape}")
        agree = block_agreement(plain_audio, audio)
        check(min(agree) >= 80.0, f"14c {name}: against its plain-kernel run {agree} dB")
        snrs = [tone_snr(audio[k, audio.shape[1] // 2:].astype(np.float64), 1000.0, 48_000.0)
                for k in tone_demods]
        check(min(snrs) > 25.0, f"14c {name}: tone SNR {snrs} dB")
        ms = elapsed / MESH_BLOCKS * 1e3
        out["launches"][name], out["ms"][name] = launches, ms
        print(f"phase 14c gear ({name}): chainsharded {'at fc_pos=sup, the capture moved up by '
              f'fs/64' if name == 'sup' else f'with chan_stages={CHAN_STAGES} in place of the PFB, '
              f'the capture moved by {shift:.0f} Hz'} on the card, 1x1 mesh, phase 5's "
              f"{MESH_BLOCKS} blocks: against the same gear on {counter.__name__}'s plain version "
              f"{[f'{a:.2f}' for a in agree]} dB per block (bar 80); {counter.__name__} "
              f"{launches} launches; tone SNR {[f'{s:.2f}' for s in snrs]} dB (demods "
              f"{tone_demods}); {ms:.3f} ms/block, plain {plain_s / MESH_BLOCKS * 1e3:.3f} "
              f"(capture resident, one run each after a warm-up block) [{tag}]", flush=True)
    return out


def phase_slice14(dev: torch.device, product_blocks: list[np.ndarray],
                  gear_blocks: list[torch.Tensor], tag: str) -> dict:
    t0 = time.perf_counter()
    formats = phase_formats(dev, product_blocks, tag)
    sessions = phase_format_sessions(dev, formats, tag)
    gear = phase_gear_forms(dev, gear_blocks, tag)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return {"launches": formats["launches"], "ms": formats["ms"],
            "upload_ms": formats["upload_ms"], "session_launches": sessions, "gear": gear}


def main() -> int:
    parser = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    parser.add_argument("--phase", type=int, choices=(14,), default=None,
                        help="run only this phase (with the blocks it reuses made anew) "
                             "and print no kernels line and no ok line")
    only = parser.parse_args().phase
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    tag = card()
    print(tag, flush=True)
    pipe = RxPipeline(
        DeviceConfig(PRODUCT_RATE, log2_decim=6),
        [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 flags still on after pipeline construction")
    print(f"phase 0 device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} [{tag}]", flush=True)

    if only == 14:  # phase 3's first block and phase 5's blocks, then phase 14
        cfg5 = chainsharded_config()
        offs5 = chainsharded_offsets(cfg5)
        gear_blocks = [torch.from_numpy(b).to(dev) for b in fm_blocks(
            3, GEAR_BLOCK, GEAR_RATE, tuple(float(offs5[k]) for k in (5, 6)), amplitude=0.35)]
        phase_slice14(dev, fm_blocks(1, PRODUCT_BLOCK, PRODUCT_RATE, 20_000.0), gear_blocks,
                      tag)
        return 0

    info = build.build()
    regs = ptxas_summary(info.ptxas)
    print(f"phase 1 build: {os.path.relpath(info.path, REPO)}, nvcc {info.seconds:.2f} s; "
          f"ptxas: {'; '.join(regs) or 'n/a'} [{tag}]", flush=True)
    lib = build.library()
    for kernel, count in (("flat_decimate_tc_kernel<", len(RATIOS)),
                          ("flat_decimate_kernel<", 4 * len(RATIOS)),
                          *((f"{k}:", 1) for k in KPLL_KERNELS)):
        lines = [line for line in regs if line.startswith(kernel)]
        check(len(lines) == count and all(" 0 bytes spill stores" in line for line in lines),
              f"{kernel} spills or is missing from the ptxas report: {lines}")
    sass = kpll_sass(info.path)
    clock_mhz = sm_clock_mhz()
    print("phase 1 build: K-PLL's critical path per step from cuobjdump -sass (the longest "
          "dependent chain through the hot loop outside the math's slow paths, 4 cycles "
          "per dependent instruction): "
          + ", ".join(f"{k} ({KPLL_SERIAL[k]}) {c:.1f} cycles ({n} instructions in the "
                      f"{kpll_unroll()[k]}-step loop)" for k, (c, n) in sass.items())
          + "; ptxas: " + "; ".join(line for line in regs if line.split(":")[0] in KPLL_KERNELS)
          + f"; max SM clock {clock_mhz:.0f} MHz [{tag}]", flush=True)
    k1_occ = {}
    for k in (2, 4, 6):
        for name, dtype, fc_pos in K1_FORMS:
            variant = (1 << k, dec.flat_legs(k).shape[1], dtype == torch.int16, fc_pos != "cen")
            k1_occ[k, name] = (k1_kernel.smem_bytes(*variant), k1_kernel.blocks_per_sm(*variant))
    print("phase 1 build: dynamic shared memory per block and blocks resident per SM: K1 "
          + ", ".join(f"k={k} {name} {b} B {n} blocks" for (k, name), (b, n) in k1_occ.items())
          + "; K1-TC " + ", ".join(f"k={k} {lib.sdr_flat_decimate_tc_smem_bytes(1 << k)} B "
                                   f"{blocks_per_sm(1 << k)} blocks" for k in (2, 4, 6))
          + f" [{tag}]", flush=True)
    check(all(n >= 2 for (k, _), (_, n) in k1_occ.items() if k == 6),
          "K1 at r=64 holds fewer than 2 blocks per SM")
    check(blocks_per_sm(64) >= 2, "K1-TC at r=64 holds fewer than 2 blocks per SM")

    k1 = phase_k1(dev, tag)
    tc = phase_k1_tc(dev, tag)
    launches, product_blocks = phase_product(pipe, tag)
    phase_cli(tag)
    tc_launches, gear_blocks = phase_bank(dev, tag)
    phase_receivers(dev, tag)
    server_launches = phase_server(pipe, product_blocks, tag)
    tx_loopback_launches = phase_tx(dev, tag)
    kpll = phase_kpll(dev, tag, sass, clock_mhz)
    sync_am = phase_sync_am(dev, tag)
    ctcss_launches = phase_ctcss(dev, tag)
    bfm_launches, bfm_capture, bfm_audio = phase_bfm(dev, tag)
    bfm_server_launches = phase_bfm_server(bfm_capture, bfm_audio, tag)
    data = phase_data(dev, tag)
    atv_launches = phase_atv(dev, tag)
    phase_data_server(data["pipe"], data["blocks"], tag)
    datv = phase_datv(dev, tag)
    phase_datv_server(datv["blocks"], tag)
    daemon_launches = phase_daemon(tag)
    phase_codec(tag)
    slice12 = phase_slice(dev, product_blocks, tag)
    mesh13 = phase_mesh(dev, gear_blocks, tag)
    slice14 = phase_slice14(dev, product_blocks, gear_blocks, tag)

    print(tag, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flat_decimate",
        "route": "cuda",
        "source": "sdrangel_tpu_torch/kernels/csrc/flat_decimate.cu",
        "replaces": "sdrangel_tpu/pallas/decimator.py:94",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "gear_block_ms": tc["k1_ms"],
        "forms": k1["forms"],
        "server_launches": server_launches,
        "tx_loopback_launches": tx_loopback_launches,
        "data_launches": {"set_a": data["k1"], "atv_set_b": atv_launches,
                          "datv": datv["k1"], "daemon_rx": daemon_launches},
        "slice12_launches": slice12["launches"],
        "flat_iq": slice12["flat_iq"],
        "mesh_launches": {"13a_2x1_inf": mesh13["launches"]["13a_2x1_inf"]},
        "format_launches": slice14["launches"],
        "format_ms": slice14["ms"],
        "format_upload_ms": slice14["upload_ms"],
        "format_session_launches": slice14["session_launches"],
        "gear_sup": {"launches": slice14["gear"]["launches"]["sup"],
                     "ms": slice14["gear"]["ms"]["sup"]},
    }, {
        "name": "flat_decimate_tc",
        "route": "cuda",
        "source": "sdrangel_tpu_torch/kernels/csrc/flat_decimate_tc.cu",
        "replaces": "sdrangel_tpu/pallas/decimator.py:165",
        "launches": tc_launches,
        "max_abs_err": tc["max_abs_err"],
        "ms": tc["ms"],
        "plain_ms": tc["plain_ms"],
        "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"],
        "library_ms": tc["library_ms"],
        "mesh_launches": {k: v for k, v in mesh13["launches"].items() if k != "13a_2x1_inf"},
        "mesh_ms": mesh13["ms"],
        "mesh_session": mesh13["session"],
        "gear_chan_stages": {"launches": slice14["gear"]["launches"]["chan_stages"],
                             "ms": slice14["gear"]["ms"]["chan_stages"]},
    }, {
        "name": "pll_scan",
        "route": "cuda",
        "source": "sdrangel_tpu_torch/kernels/csrc/pll_scan.cu",
        "replaces": "sdrangel_tpu/dsp/phaselock.py:33",
        "launches": sync_am["usb"]["kpll"],
        "max_abs_err": max(v["max_abs_err"] for v in kpll.values()),
        "ms": kpll["pll_run"]["ms"],
        "plain_ms": kpll["pll_run"]["plain_ms"],
        "bound_ms": kpll["pll_run"]["bound_ms"],
        "bound_by": kpll["pll_run"]["bound_by"],
        "library_ms": None,
        "latency_bound_ms": kpll["pll_run"]["latency_bound_ms"],
        "entries": {k: {"launches": sync_am["usb"]["per_entry"][k],
                        **{f: v[f] for f in ("ms", "ms_16ch", "plain_ms", "plain_samples",
                                             "bound_ms", "bound_by", "latency_bound_ms",
                                             "chain_cycles_per_step", "cycles_per_step",
                                             "max_abs_err", "kernel_ms")}}
                    for k, v in kpll.items()},
        "dsb_launches": sync_am["dsb"]["kpll"],
        "slice_k1_launches": {"sync_am": sync_am["usb"]["k1"], "ctcss": ctcss_launches,
                              "bfm": bfm_launches, "bfm_server": bfm_server_launches},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
