"""RDS-TMC (ALERT-C, ISO 14819) decode: single- and multi-group user
messages, duration/persistence, optional free-format content, quantifiers.

Reference: plugins/channelrx/demodbfm/rdstmc.cpp (the ISO 14819-2 event
table) and rdsparser.cpp decode_type8/decode_optional_content
(rdsparser.cpp:858-955). This module implements the machinery the
reference only logs: multi-group messages are assembled per continuity
index and their free-format bit stream is parsed into (label, value)
fields per ISO 14819-1 §5.5 — the reference's decode_optional_content
walks the same stream but collapses every field to a boolean
(rdsparser.cpp:941-948 `free_format[i] && (mask != 0)`), losing the
values. Event texts come from the full ISO 14819-2 Table 2 event list
(rdstmc_events.py, 1402 codes — the reference vendors the same standard
data as a 2048-row list-line array plus a code->line lookup table,
rdstmc.cpp:30-2079/1628-3677; we key by event code directly); unknown codes fall back to the numeric code, which
is always reported alongside.

The port's own copy of the JAX package's module (sdrangel_tpu/channels/rdstmc.py),
held equal to it by tests/test_torch_rds.py. It is host code and stays on the host.
"""

from __future__ import annotations

import dataclasses

from .rdstmc_events import EVENTS  # code -> (CEN-English text, quantifier type)

#: duration & persistence text, [dp][0]=transient/[dp][1]=lasting
#: (ISO 14819-1 table; rdsparser.cpp:199-209)
DURATION = [
    ("no duration given", "no duration given"),
    ("15 minutes", "next few hours"),
    ("30 minutes", "rest of the day"),
    ("1 hour", "until tomorrow evening"),
    ("2 hours", "rest of the week"),
    ("3 hours", "end of next week"),
    ("4 hours", "end of the month"),
    ("rest of the day", "long period"),
]

#: optional message content field lengths per label (ISO 14819-1 page 15;
#: rdsparser.cpp:213)
LABEL_LENGTHS = [3, 3, 5, 5, 5, 8, 8, 8, 8, 11, 16, 16, 16, 16, 0, 0]

LABEL_NAMES = [
    "duration", "control_code", "length_km", "speed_limit",
    "quantifier_5bit", "quantifier_8bit", "supplementary_info",
    "start_time", "stop_time", "additional_event", "diversion",
    "destination", "rfu_12", "cross_linkage", "separator", "rfu_15",
]

#: quantifier type descriptions (ISO 14819-2 table 1 §3.1.2; the reference
#: vendors the same 13 rows, rdstmc.cpp:3681-3695)
QUANT_TYPES = [
    "n (small number)", "N (number)", "less than V metres", "P percent",
    "of up to S km/h", "of up to M minutes", "T degrees Celsius", "H time",
    "W tonnes", "L metres", "of up to D millimetres", "M MHz", "k kHz",
]


def event_text(code: int, quantifier: int | None = None) -> str:
    """Event display text; a quantifier value substitutes into the text's
    Q placeholder with the ISO 14819-2 type description as the unit hint
    (the reference stores the type column but never renders values).

    The table's placeholder appears in many shapes — "(Q)", "(Q sets of)",
    "involving Q vehicles", "(Q th)" — so substitution targets the
    standalone Q token; texts without one get the value appended."""
    text, qt = EVENTS.get(code, (f"event {code}", None))
    if quantifier is None:
        return text
    q = (f"Q={quantifier}" if qt is None
         else f"Q={quantifier} [{QUANT_TYPES[qt]}]")
    import re

    sub, n = re.subn(r"\bQ\b", q, text)
    return sub if n else f"{text} ({q})"


def format_quantifier(label: int, value: int) -> str:
    """Human form of a quantifier field per its label width (ISO 14819-1
    §5.5.2: label 4 = 5-bit quantifier, label 5 = 8-bit quantifier)."""
    if label == 2:
        return f"{value} km"
    if label == 3:
        return f"{value * 5} km/h" if value else "speed limit"
    if label in (7, 8):  # explicit start/stop time (ISO 14819-1 table)
        if value <= 95:
            return f"{value // 4:02d}:{(value % 4) * 15:02d}"
        if value <= 200:
            return f"day +{(value - 96) // 24}, {(value - 96) % 24:02d}:00"
        if value <= 231:
            return f"day {value - 200} of the month"
        return f"mid-month slot {value - 231}"
    return str(value)


@dataclasses.dataclass
class TmcMessage:
    """One assembled ALERT-C user message."""

    single_group: bool
    duration_code: int  # dp (single-group) or continuity index (multi)
    diversion: bool
    direction: int  # 0 = positive, 1 = negative
    extent: int  # affected segments - 1
    event: int
    location: int
    event_text: str = ""
    duration_text: str = ""
    fields: list = dataclasses.field(default_factory=list)  # optional content
    complete: bool = True

    def describe(self) -> dict:
        return {
            "singleGroup": self.single_group,
            "duration": self.duration_code,
            "durationText": self.duration_text,
            "diversion": self.diversion,
            "direction": self.direction,
            "extent": self.extent,
            "event": self.event,
            "eventText": self.event_text,
            "location": self.location,
            "fields": list(self.fields),
            "complete": self.complete,
        }


def parse_free_format(words: list[int]) -> list[dict]:
    """Parse the concatenated 28-bit free-format words of a multi-group
    message into labelled fields (ISO 14819-1 §5.5; fixes the boolean
    collapse of rdsparser.cpp:941-948)."""
    bits = 0
    nbits = 0
    for w in words:
        bits = (bits << 28) | (w & 0x0FFFFFFF)
        nbits += 28
    fields = []
    pos = nbits
    while pos >= 4:
        pos -= 4
        label = (bits >> pos) & 0xF
        length = LABEL_LENGTHS[label]
        if pos < length:
            break
        pos -= length
        value = (bits >> pos) & ((1 << length) - 1) if length else 0
        if label == 14 and value == 0:
            continue  # separator
        if label == 0 and value == 0 and pos < 4:
            break  # trailing padding
        fields.append({
            "label": label,
            "name": LABEL_NAMES[label],
            "value": value,
            "text": format_quantifier(label, value),
        })
    return fields


class TmcDecoder:
    """Stateful ALERT-C group-8A decoder.

    feed(g) with g = the four 16-bit RDS blocks of an 8A group; returns a
    TmcMessage when one completes (single-group immediately; multi-group
    once its last free-format group — gsi 0 — arrives), else None.
    """

    def __init__(self):
        self._first: TmcMessage | None = None  # awaiting continuation
        self._ci: int = -1
        self._parts: dict[int, int] = {}  # gsi -> free-format word
        self._expect: int = 0

    def feed(self, g) -> TmcMessage | None:
        tuning = (g[1] >> 4) & 1
        if tuning:
            return None  # tuning info variants: no user message
        single = bool((g[1] >> 3) & 1)
        diversion = bool((g[2] >> 15) & 1)
        if single or diversion:
            # single-group, or first group of a multi-group message
            # (rdsparser.cpp:882-901 uses the same F||D discriminator)
            dp_ci = g[1] & 0x7
            msg = TmcMessage(
                single_group=single,
                duration_code=dp_ci,
                diversion=diversion,
                direction=(g[2] >> 14) & 1,
                extent=(g[2] >> 11) & 0x7,
                event=g[2] & 0x7FF,
                location=g[3],
                event_text=event_text(g[2] & 0x7FF),
            )
            if single:
                msg.duration_text = DURATION[dp_ci][0]
                return msg
            self._first = msg
            self._ci = dp_ci
            self._parts = {}
            self._expect = 0
            return None
        # subsequent group of a multi-group message
        ci = g[1] & 0x7
        if self._first is None or ci != self._ci:
            return None  # continuation without its first group
        second = (g[2] >> 14) & 1
        gsi = (g[2] >> 12) & 0x3
        if second:
            self._expect = gsi
        self._parts[gsi] = ((g[2] & 0xFFF) << 16) | g[3]
        if gsi != 0:
            return None
        msg = self._first
        self._first = None
        words = [self._parts[i] for i in sorted(self._parts, reverse=True)]
        msg.fields = parse_free_format(words)
        msg.complete = len(self._parts) >= self._expect + 1
        # a quantifier field re-renders the event text with its value
        # substituted into the (Q) placeholder (ISO 14819-2 §3.1.2)
        for f in msg.fields:
            if f.get("label") in (4, 5):
                msg.event_text = event_text(msg.event, f["value"])
                break
        return msg
