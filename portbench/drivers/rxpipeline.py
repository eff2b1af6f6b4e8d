"""The Rx product path: `RxPipeline.run` — upload, `step_packed`, and the
packed outputs fetched one block behind — the loop of the `demod --in`
CLI, whose `step_packed` the session's worker drives too."""

from __future__ import annotations

import numpy as np

from .. import judge
from . import kernel_launches
from ..reference import chains

SPANS = ("feed", "step", "fetch")


def block_samples(config: dict) -> int:
    return config["device_block"]


def frequencies(config: dict, traffic: dict):
    return traffic["channels_hz"]


def reference(config: dict, traffic: dict, raws, arith):
    return chains.product(raws, config, traffic["channels_hz"], arith)


def numbers(ours, ref) -> dict:
    return judge.product_numbers(ours, ref)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return np.array(tree)


class System:
    """An RxPipeline of the configuration's NFM channels at the traffic's
    offsets, fed from the ring of host blocks in order."""

    def __init__(self, config: dict, traffic: dict, ring, device):
        from sdrangel_tpu_torch.dsp.spectrum import SpectrumConfig
        from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

        ch = config["channel"]
        settings = {k: ch[k] for k in ("audio_rate", "rf_bandwidth", "af_bandwidth",
                                       "fm_deviation", "squelch_db", "squelch_gate_ms", "volume")}
        sp = config["spectrum"]
        if sp["window"] != "hanning":
            raise ValueError("the configuration's spectrum window must be hanning")
        self.pipe = RxPipeline(
            DeviceConfig(float(config["sample_rate"]), log2_decim=config["log2_decim"],
                         fc_pos=config["fc_pos"], input_format=config["input_format"]),
            [ChannelSpec(ch["uri"], float(f), dict(settings), float(ch["requested_rate"]))
             for f in traffic["channels_hz"]],
            device, block_size=config["device_block"] >> config["log2_decim"],
            spectrum_cfg=SpectrumConfig(fft_size=sp["fft_size"], averaging_mode=sp["averaging"],
                                        averaging_n=sp["averaging_n"]))
        if self.pipe.device_block != config["device_block"]:
            raise ValueError(f"the pipeline's block is {self.pipe.device_block}, the "
                             f"configuration's {config['device_block']}")
        self.ring = ring
        self.hooks = None
        self.ranges = tuple("portbench " + s for s in SPANS)
        # the harness's spans around the loop's own calls, on this instance
        for name, method in zip(SPANS, ("upload", "step_packed", "to_host")):
            setattr(self.pipe, method, self._spanned(name, getattr(self.pipe, method)))

    def _spanned(self, name, fn):
        def call(*args, **kwargs):
            with self.hooks.span(name):
                return fn(*args, **kwargs)
        return call

    def loop(self, hooks):
        self.hooks = hooks
        ring = self.ring

        def source(b, count):
            hooks.feed(b)
            return ring[b % len(ring)]

        return self.pipe.run(source, 1 << 62)

    copy = staticmethod(_copy)

    launches = staticmethod(kernel_launches)

    def close(self) -> None:
        del self.pipe
