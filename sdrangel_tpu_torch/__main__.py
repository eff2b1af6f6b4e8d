"""CLI — headless Rx pipeline runner and REST server on a chosen torch device.

Examples:
  # the product path on the card: 10 MS/s i16, ÷64, NFM at +20 kHz
  python -m sdrangel_tpu_torch demod --device cuda --test-fm 1000 \
      --rate 10000000 --log2-decim 6 --channel nfm:20000 --squelch -60 \
      --out audio.wav

  # demodulate a .sdriq capture
  python -m sdrangel_tpu_torch demod --device cuda --in capture.sdriq \
      --log2-decim 2 --channel nfm:50000 --out audio.wav

  # inspect a capture
  python -m sdrangel_tpu_torch info --in capture.sdriq

  # the REST control plane (the sdrangelsrv role) on the card
  python -m sdrangel_tpu_torch server --device cuda --api-port 8091
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_CHANNEL_URIS = {
    "nfm": "sdrangel.channel.nfmdemod",
    "am": "sdrangel.channel.amdemod",
    "ssb": "sdrangel.channel.ssbdemod",
    "wfm": "sdrangel.channel.wfmdemod",
}


def _parse_channel(spec: str) -> tuple[str, float]:
    kind, _, rest = spec.partition(":")
    if kind not in _CHANNEL_URIS:
        raise SystemExit(f"channel kind {kind!r} is not ported yet; ported: "
                         f"{sorted(_CHANNEL_URIS)}")
    return _CHANNEL_URIS[kind], float(rest) if rest else 0.0


def cmd_info(args) -> int:
    from .io import sdriq

    info = sdriq.read_header(args.infile)
    print(f"sample_rate:       {info.sample_rate} S/s")
    print(f"center_frequency:  {info.center_frequency} Hz")
    print(f"start_timestamp:   {info.start_timestamp}")
    print(f"sample_size:       {info.sample_size} bit")
    print(f"n_samples:         {info.n_samples} ({info.n_samples / info.sample_rate:.3f} s)")
    return 0


def cmd_demod(args) -> int:
    import torch

    from .channels.registry import REGISTRY
    from .io import sdriq, testsource, wav
    from .runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

    parsed = [_parse_channel(c) for c in args.channel]

    def settings(uri: str) -> dict:
        # --squelch goes to the kinds that have a squelch (SSB's is its AGC's)
        if args.squelch is None or "squelch_db" not in REGISTRY[uri].dynamic_fields:
            return {}
        return {"squelch_db": args.squelch}

    if args.infile:
        info, mm = sdriq.open_mmap(args.infile)
        rate = float(info.sample_rate)
        total = info.n_samples
        input_format = "i16" if info.sample_size == 16 else "i24"

        def source(b, count):
            return sdriq.read_block(mm, b * count, count)
    else:
        rate = args.rate
        input_format = "i16"
        cfg_src = testsource.TestSourceConfig(
            sample_rate=rate,
            carrier_freq=parsed[0][1],
            modulation="fm" if args.test_fm else ("am" if args.test_am else "none"),
            tone_freq=args.test_fm or args.test_am or 1000.0,
            fm_deviation=5000.0,
            amplitude=0.5,
        )

        def source(b, count):
            return testsource.to_iq_int16(
                testsource.generate(cfg_src, count, start_sample=b * count))

        total = int(args.seconds * rate)

    frontend = DeviceConfig(
        sample_rate=rate, log2_decim=args.log2_decim, fc_pos=args.fc_pos,
        dc_correction=args.dc_correction, iq_correction=args.iq_correction,
        input_format=input_format,
    )
    pipe = RxPipeline(
        frontend, [ChannelSpec(uri, offset, settings(uri)) for uri, offset in parsed],
        torch.device(args.device),
    )
    n_blocks = max(1, total // pipe.device_block)
    print(
        f"device {pipe.device}; rate {rate:.0f} S/s /{1 << args.log2_decim} -> baseband "
        f"{frontend.baseband_rate:.0f} S/s; channel plan: {pipe.plans[0]}",
        file=sys.stderr,
    )
    print(f"block {pipe.device_block} device samples, {n_blocks} blocks", file=sys.stderr)

    audio_parts = [[] for _ in parsed]
    t0 = time.perf_counter()
    for _, outs in pipe.run(source, n_blocks):
        for c in range(len(parsed)):
            audio_parts[c].append(outs["channels"][c]["audio"])
    elapsed = time.perf_counter() - t0
    audio = np.concatenate(audio_parts[0], axis=-1)
    wav.write_wav(args.out, audio, 48000)
    for c in range(1, len(parsed)):  # extra channels: suffixed files
        root, ext = args.out.rsplit(".", 1)
        wav.write_wav(f"{root}.ch{c}.{ext}", np.concatenate(audio_parts[c], axis=-1), 48000)
    processed = n_blocks * pipe.device_block
    print(
        f"processed {processed} samples in {elapsed:.2f}s on {pipe.device} "
        f"({processed / elapsed / 1e6:.1f} MS/s, {processed / rate / elapsed:.1f}x real time); "
        f"wrote {audio.shape[-1]} audio samples to {args.out}",
        file=sys.stderr,
    )
    return 0


def cmd_server(args) -> int:
    import logging

    from .api.server import serve_forever

    logging.basicConfig(level=logging.INFO)
    try:
        serve_forever(args.api_address, args.api_port, args.api_token, args.device)
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdrangel_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="inspect a .sdriq capture")
    pi.add_argument("--in", dest="infile", required=True)
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("demod", help="demodulate channels to WAV")
    pd.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (the default), cuda:N or cpu")
    pd.add_argument("--in", dest="infile", help=".sdriq input (else synthetic)")
    pd.add_argument("--rate", type=float, default=768000.0, help="synthetic source rate")
    pd.add_argument("--seconds", type=float, default=2.0, help="synthetic duration")
    pd.add_argument("--test-fm", type=float, default=None, metavar="TONE_HZ")
    pd.add_argument("--test-am", type=float, default=None, metavar="TONE_HZ")
    pd.add_argument("--log2-decim", type=int, default=0, choices=range(7))
    pd.add_argument("--fc-pos", default="cen", choices=["cen", "inf", "sup"])
    pd.add_argument("--channel", required=True, action="append",
                    help="kind:offset_hz (nfm|am|ssb|wfm); repeatable")
    pd.add_argument("--squelch", type=float, default=None, help="squelch dB")
    pd.add_argument("--dc-correction", action="store_true")
    pd.add_argument("--iq-correction", action="store_true")
    pd.add_argument("--out", required=True, help="output WAV path")
    pd.set_defaults(fn=cmd_demod)

    ps = sub.add_parser("server", help="run the REST API server (sdrangelsrv role)")
    ps.add_argument("--api-address", default="127.0.0.1")
    ps.add_argument("--api-port", type=int, default=8091,
                    help="listening port (mainparser.cpp default); 0 takes a free one")
    ps.add_argument("--api-token", default=None,
                    help="require 'Authorization: Bearer <token>' on every request "
                         "(or set SDRANGEL_TPU_API_TOKEN)")
    ps.add_argument("--device", default="cuda",
                    help="torch device the device sets run on: cuda (the default), "
                         "cuda:N or cpu")
    ps.set_defaults(fn=cmd_server)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
