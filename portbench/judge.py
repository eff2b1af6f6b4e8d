"""The comparison that decides `correct`: the numbers compared between
what the timed path produced and what the plain reference works out
from the same capture, and each number's limit (`limits/<cell>.json`)."""

from __future__ import annotations

import math

import numpy as np


def rel_err(got, want) -> float:
    """‖got − want‖ / ‖want‖ (0 where both are zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return float(num / den)


#: a sample is off where it misses the reference by more than this share
#: of the channel's RMS audio
OFF = 1e-3


def off_share(got, want) -> float:
    """The share of samples that miss `want` by more than OFF × its RMS."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    if np.isnan(got).any():
        return math.nan
    return float(np.mean(np.abs(got - want) > OFF * np.sqrt(np.mean(want ** 2))))


#: the audio samples at the head of a block, where a state the step lost
#: shows in every channel
HEAD = 2048


def head_err(got_rows, want_rows) -> float:
    """The median over the channels that the reference hears in the
    block's first HEAD audio samples (over all, where it hears none) of
    their relative error there: every such head misses where the carried
    state is wrong, while a click in one channel moves no median. A
    channel whose squelch is shut is all zeros, and the numbers of the
    whole block judge it."""
    pairs = [(np.asarray(o)[:HEAD], np.asarray(r)[:HEAD]) for o, r in zip(got_rows, want_rows)]
    heard = [(o, r) for o, r in pairs if np.any(r)] or pairs
    errs = [rel_err(o, r) for o, r in heard]
    return math.nan if any(math.isnan(e) for e in errs) else float(np.median(errs))


def worst(values) -> float:
    """The largest value, NaN if any is NaN."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def product_numbers(ours: dict, ref: dict) -> dict:
    """One block of the product path: the worst channel's audio (relative
    to the reference's, and its share of samples off), the channels' heads,
    the worst power meter,
    the spectrum's and the scope's dB rows (largest gap in dB) and the
    scope's I/Q head (relative)."""
    if len(ours["channels"]) != len(ref["channels"]):
        return {"audio_err": math.inf, "audio_off_share": math.inf, "audio_head_err": math.inf}
    pairs = list(zip(ours["channels"], ref["channels"]))
    return {
        "audio_err": worst(rel_err(o["audio"], r["audio"]) for o, r in pairs),
        "audio_off_share": worst(off_share(o["audio"], r["audio"]) for o, r in pairs),
        "audio_head_err": head_err([o["audio"] for o, _ in pairs], [r["audio"] for _, r in pairs]),
        "power_err": worst(abs(float(o["power"]) - r["power"]) / r["power"] for o, r in pairs),
        "spectrum_db_err": float(np.max(np.abs(np.asarray(ours["spectrum"], np.float64)
                                               - ref["spectrum"]))),
        "scope_err": rel_err(np.asarray(ours["scope"])[:2], ref["scope"][:2]),
        "scope_db_err": float(np.max(np.abs(np.asarray(ours["scope"][2], np.float64)
                                            - ref["scope"][2]))),
    }


def bank_numbers(ours: np.ndarray, ref: np.ndarray) -> dict:
    """One block of the bank: the worst demod's audio, relative, and its
    share of samples off; the demods' heads."""
    if np.shape(ours) != np.shape(ref):
        return {"audio_err": math.inf, "audio_off_share": math.inf, "audio_head_err": math.inf}
    return {"audio_err": worst(rel_err(o, r) for o, r in zip(ours, ref)),
            "audio_off_share": worst(off_share(o, r) for o, r in zip(ours, ref)),
            "audio_head_err": head_err(ours, ref)}


def combine(per_block: list[dict]) -> dict:
    """The worst of each number over the blocks compared (none: nothing)."""
    names = list(per_block[0]) if per_block else []
    return {k: worst(b.get(k, math.inf) for b in per_block) for k in names}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that the cell's limits name within its limit,
    {name: {"value", "limit"}}). A NaN fails, and so does a limit with no
    number to hold."""
    check = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        check[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, check
