"""The port's channel banks have one home (channels/registry.py): for every
Rx kind, `ChannelKind.bankable` says whether `RxPipeline` banks two of its
channels at one depth, whether the bank gear (`build_sharded_step`) takes a
group of it, and whether the session's sharded plan does; and the session's
per-block overrides (`_live_dyn`) equal the pipeline's bound ones
(`default_dyn`) while no live setting has changed.
"""

import pytest

from sdrangel_tpu_torch.channels import registry as preg
from sdrangel_tpu_torch.parallel import sharded as psh
from sdrangel_tpu_torch.runtime import engine as peng
from sdrangel_tpu_torch.runtime.session import Session
from torch_port_util import CPU

#: a device rate every kind's channel plan and block fit (DATV's 1 MS/s
#: asks for whole samples a symbol)
RATE = 2_500_000.0
#: the kinds that run as banks
BANKABLE = {"sdrangel.channel.nfmdemod", "sdrangel.channel.amdemod",
            "sdrangel.channel.ssbdemod", "sdrangel.channel.wfmdemod", "sdrangel.channel.bfm"}


def _pipeline(uri: str, offsets, settings=None) -> peng.RxPipeline:
    settings = settings or {}
    specs = [peng.ChannelSpec(uri, f, settings, preg.requested_rate(uri, settings))
             for f in offsets]
    return peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1), specs, CPU)


def _accepts(fn) -> bool:
    try:
        fn()
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("uri", sorted(preg.REGISTRY))
def test_bankable_is_what_every_caller_banks(uri):
    kind = preg.REGISTRY[uri]
    assert kind.bankable == (uri in BANKABLE)
    pipe = _pipeline(uri, (-RATE / 16, RATE / 16))
    assert len(pipe.plans[0].signs) == len(pipe.plans[1].signs)
    banked = [g.idxs for g in pipe.groups] == [(0, 1)]
    assert banked == all(g.batched for g in pipe.groups)

    cfg = psh.ShardedPipelineConfig(n_time=1, n_channel=1, log2_decim=3, block=1 << 14,
                                    bank=(psh.BankGroup(uri, 2),))
    gear = _accepts(lambda: psh.build_sharded_step(cfg, CPU))

    ds = Session(device=CPU).add_device_set()
    for f in (-20_000.0, 20_000.0):
        ds.add_channel(uri, {"inputFrequencyOffset": f})
    plan = _accepts(lambda: ds._bank_plan(1))
    assert (kind.bankable, banked, gear, plan) == (kind.bankable,) * 4


@pytest.mark.parametrize("uri", sorted(preg.REGISTRY))
def test_live_dyn_is_default_dyn_without_a_live_change(uri):
    """A channel whose settings set every field it takes per block: the
    session's per-block overrides are the pipeline's bound ones, and no
    rebuild is asked for."""
    kind = preg.REGISTRY[uri]
    settings = {k: v for k, v in (("squelch_db", -45.0), ("volume", 0.5))
                if k in kind.dynamic_fields}
    ds = Session(device=CPU).add_device_set()
    ds.update_source({"sample_rate": RATE, "log2_decim": 1})
    ds.add_channel(uri, {"inputFrequencyOffset": 30_000.0, **settings})
    with ds._lock:
        pipe, _ = ds._build_pipeline()
        dyn, rebuild = ds._live_dyn(pipe)
    assert not rebuild
    assert dyn == pipe.default_dyn()
    assert set(dyn[0]) == kind.dynamic_fields
    assert {k: dyn[0][k] for k in settings} == settings
