"""CLI — headless Rx and Tx pipeline runners and the REST server on a chosen
torch device.

Examples:
  # the product path on the card: 10 MS/s i16, ÷64, NFM at +20 kHz
  python -m sdrangel_tpu_torch demod --device cuda --test-fm 1000 \
      --rate 10000000 --log2-decim 6 --channel nfm:20000 --squelch -60 \
      --out audio.wav

  # demodulate a .sdriq capture
  python -m sdrangel_tpu_torch demod --device cuda --in capture.sdriq \
      --log2-decim 2 --channel nfm:50000 --out audio.wav

  # broadcast FM stereo to a 2-channel WAV; NFM behind a CTCSS tone gate;
  # synchronous AM (--set applies a channel setting to every channel that
  # has it)
  python -m sdrangel_tpu_torch demod --in fm.sdriq --log2-decim 5 \
      --channel bfm:0 --out stereo.wav
  python -m sdrangel_tpu_torch demod --in capture.sdriq --log2-decim 6 \
      --channel nfm:20000 --set ctcss_on=true --set ctcss_index=8 --out audio.wav
  python -m sdrangel_tpu_torch demod --in capture.sdriq --log2-decim 6 \
      --channel am:20000 --set sync_am=true --set sync_dsb=true --out audio.wav

  # inspect a capture
  python -m sdrangel_tpu_torch info --in capture.sdriq

  # modulate a 1 kHz tone onto NFM at +20 kHz, ×64 to a 9.6 MS/s .sdriq
  python -m sdrangel_tpu_torch mod --device cuda --channel nfm:20000 \
      --rate 9600000 --log2-interp 6 --seconds 2 --out tx.sdriq

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
    "bfm": "sdrangel.channel.bfm",
}


def _parse_channel(spec: str) -> tuple[str, float]:
    kind, _, rest = spec.partition(":")
    if kind not in _CHANNEL_URIS:
        raise SystemExit(f"channel kind {kind!r} is not ported yet; ported: "
                         f"{sorted(_CHANNEL_URIS)}")
    return _CHANNEL_URIS[kind], float(rest) if rest else 0.0


def _parse_settings(pairs: list[str], uris: list[str]) -> dict[str, dict]:
    """--set KEY=VALUE pairs as per-channel settings: each key goes to every
    channel whose kind has that field, its value parsed by the field's type
    (bool as true/false/1/0)."""
    from .channels.registry import settings_schema

    out: dict[str, dict] = {uri: {} for uri in uris}
    for pair in pairs:
        key, sep, text = pair.partition("=")
        if not sep:
            raise SystemExit(f"--set {pair!r}: expected KEY=VALUE")
        hits = [uri for uri in uris if key in settings_schema(uri)]
        if not hits:
            raise SystemExit(f"--set {key}: no channel here has that setting")
        for uri in hits:
            kind = settings_schema(uri)[key]["type"]
            if kind == "bool":
                if text.lower() not in ("true", "false", "1", "0"):
                    raise SystemExit(f"--set {key}={text}: expected true or false")
                out[uri][key] = text.lower() in ("true", "1")
            else:
                out[uri][key] = {"int": int, "float": float}.get(kind, str)(text)
    return out


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

    from .channels.registry import REGISTRY, requested_rate
    from .io import sdriq, testsource, wav
    from .runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

    parsed = [_parse_channel(c) for c in args.channel]
    extra = _parse_settings(args.set, [uri for uri, _ in parsed])

    def settings(uri: str) -> dict:
        # --squelch goes to the kinds that have a squelch (SSB's is its AGC's)
        st = dict(extra[uri])
        if args.squelch is not None and "squelch_db" in REGISTRY[uri].dynamic_fields:
            st["squelch_db"] = args.squelch
        return st

    if args.infile:
        from .io import native

        info, mm = sdriq.open_mmap(args.infile)
        rate = float(info.sample_rate)
        total = info.n_samples
        input_format = "i16" if info.sample_size == 16 else "i24"
        # a 16-bit capture through the C++ loader when it builds (a 24-bit
        # one keeps its 24 bits through the memmap)
        if input_format == "i16" and native.available():
            nf = native.NativeSdriq(args.infile)

            def source(b, count):
                return nf.read_i16(b * count, count)
        else:
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
        frontend, [ChannelSpec(uri, offset, settings(uri), requested_rate(uri, settings(uri)))
                   for uri, offset in parsed],
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
    # audio frames: (A,) mono, or (A, 2) stereo for broadcast FM
    audio = np.concatenate(audio_parts[0], axis=0)
    wav.write_wav(args.out, audio, 48000)
    for c in range(1, len(parsed)):  # extra channels: suffixed files
        root, ext = args.out.rsplit(".", 1)
        wav.write_wav(f"{root}.ch{c}.{ext}", np.concatenate(audio_parts[c], axis=0), 48000)
    processed = n_blocks * pipe.device_block
    print(
        f"processed {processed} samples in {elapsed:.2f}s on {pipe.device} "
        f"({processed / elapsed / 1e6:.1f} MS/s, {processed / rate / elapsed:.1f}x real time); "
        f"wrote {audio.shape[0]} audio frames to {args.out}",
        file=sys.stderr,
    )
    return 0


_MOD_URIS = {
    "nfm": "sdrangel.channeltx.modnfm",
    "am": "sdrangel.channeltx.modam",
    "ssb": "sdrangel.channeltx.modssb",
    "wfm": "sdrangel.channeltx.modwfm",
}


def cmd_mod(args) -> int:
    import torch

    from .channels import cwkeyer
    from .io import sdriq
    from .runtime.tx import BLOCK_AF, TxChannelSpec, TxDeviceConfig, TxPipeline

    kind, _, rest = args.channel.partition(":")
    if kind not in _MOD_URIS:
        raise SystemExit(f"modulator kind {kind!r} is not ported yet; ported: "
                         f"{sorted(_MOD_URIS)}")
    sink = TxDeviceConfig(sample_rate=args.rate, log2_interp=args.log2_interp)
    pipe = TxPipeline(sink, [TxChannelSpec(_MOD_URIS[kind], float(rest) if rest else 0.0, {})],
                      BLOCK_AF, torch.device(args.device))
    keyer = (cwkeyer.CWKeyer(args.cw, cwkeyer.CWConfig(wpm=args.wpm), loop=True)
             if args.cw else None)

    def af(b, c, count):
        tt = (b * count + np.arange(count)) / 48000.0
        tone = np.sin(2 * np.pi * args.tone * tt).astype(np.float32)
        return tone if keyer is None else tone * keyer.next_block(count)

    n_blocks = max(1, int(args.seconds * 48000.0) // BLOCK_AF)
    print(f"device {pipe.device}; {n_blocks} blocks of {pipe.device_block} samples at "
          f"{args.rate:.0f} S/s (x{1 << args.log2_interp} from {sink.baseband_rate:.0f} S/s); "
          f"channel plan: {pipe.plans[0]}", file=sys.stderr)
    writer = sdriq.SdriqWriter(args.out, sample_rate=int(args.rate))
    t0 = time.perf_counter()
    try:
        for block in pipe.run(af, n_blocks):
            writer.write(block)
    finally:
        writer.close()
    elapsed = time.perf_counter() - t0
    n = writer.samples_written
    print(f"wrote {n} samples ({n / args.rate:.2f} s at {args.rate:.0f} S/s) to {args.out} "
          f"in {elapsed:.2f} s on {pipe.device} ({n / args.rate / elapsed:.1f}x real time)",
          file=sys.stderr)
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
                    help="kind:offset_hz (nfm|am|ssb|wfm|bfm); repeatable")
    pd.add_argument("--squelch", type=float, default=None, help="squelch dB")
    pd.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a channel setting (a field of its kind, e.g. ctcss_on=true, "
                         "ctcss_index=8, delta_squelch=true, sync_am=true, sync_dsb=true, "
                         "audio_stereo=false) for every channel that has it; repeatable")
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

    pt = sub.add_parser("mod", help="modulate a tone to a .sdriq file")
    pt.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (the default), cuda:N or cpu")
    pt.add_argument("--channel", required=True, help="kind:offset_hz (nfm|am|ssb|wfm)")
    pt.add_argument("--rate", type=float, default=384000.0, help="DAC sample rate")
    pt.add_argument("--log2-interp", type=int, default=0, choices=range(7))
    pt.add_argument("--tone", type=float, default=1000.0, help="AF tone Hz")
    pt.add_argument("--cw", default=None, metavar="TEXT", help="CW keying text")
    pt.add_argument("--wpm", type=float, default=15.0)
    pt.add_argument("--seconds", type=float, default=2.0)
    pt.add_argument("--out", required=True, help="output .sdriq path")
    pt.set_defaults(fn=cmd_mod)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
