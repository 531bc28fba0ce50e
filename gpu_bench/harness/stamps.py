"""Traced runs: the readings of the program's stamped window.

A record is what ``utils/profiling.Recorder.read`` returns in ``stamps``
mode: spans with host stamps, device stamps put on the host clock by an
anchor (an event placed at the middle of its host round trip, so each
device time is off by up to half that round trip), the anchors' round
trips, and counters per control step. A traced run keeps
``{"window": record, "build": record}`` in ``run.extra["stamps"]``: the
window's control steps are its steps >= 0, the build's spans are host
only. The definitions are the benchmark's, frozen here beside ``STAGES``
(``harness/trace.py``), whose labels the program's spans carry.
"""

from __future__ import annotations

import numpy as np

# a span whose exit event ran within this many microseconds of its host
# exit stamp is host-paced: the card had caught up with the host there.
# Spans placed by an anchor whose round trip is longer are left out: half
# of it, the clock's error, would blur the rule
PACED_US = 50.0


def record_of(run, part: str = "window") -> dict | None:
    stamps = getattr(run, "extra", {}).get("stamps")
    return stamps.get(part) if stamps else None


def _ms(pair) -> float:
    return pair[1] - pair[0]


def _steps(record: dict) -> list:
    return sorted({s["step"] for s in record["spans"] if s["step"] >= 0})


def _under(spans: list, i: int, label: str) -> bool:
    p = spans[i]["parent"]
    while p >= 0 and spans[p]["label"] != label:
        p = spans[p]["parent"]
    return p >= 0


def ik_event_ms(record: dict) -> float | None:
    """Median per control step of the device ms of its "IK" spans, both
    calls summed."""
    per: dict = {}
    for s in record["spans"]:
        if s["label"] == "IK" and s["step"] >= 0 and s["device"]:
            per[s["step"]] = per.get(s["step"], 0.0) + _ms(s["device"])
    return float(np.median(list(per.values()))) if per else None


def render_event_ms(record: dict) -> float | None:
    """Median per control step of the device ms of "render: other" less
    the "IK" spans inside it."""
    spans = record["spans"]
    per: dict = {}
    for s in spans:
        if s["label"] == "render: other" and s["step"] >= 0 and s["device"]:
            per[s["step"]] = per.get(s["step"], 0.0) + _ms(s["device"])
    for i, s in enumerate(spans):
        if (s["label"] == "IK" and s["step"] in per and s["device"]
                and _under(spans, i, "render: other")):
            per[s["step"]] -= _ms(s["device"])
    return float(np.median(list(per.values()))) if per else None


def exit_lags_us(record: dict) -> list:
    """(label, device exit less host exit in us, the anchor's round trip
    in us) of each leaf span of the control steps: a span with device
    stamps and no child with device stamps."""
    spans = record["spans"]
    parents = {s["parent"] for s in spans if s["device"]}
    rtt = record["anchor_rtt_us"]
    return [(s["label"], (s["device"][1] - s["host"][1]) * 1e3,
             rtt[s["anchor"]])
            for i, s in enumerate(spans)
            if s["device"] and s["step"] >= 0 and i not in parents]


def host_paced_pct(record: dict) -> float | None:
    """The share of the leaf spans' device ms that lies in spans whose
    exit event ran within PACED_US of their host exit, over the spans
    placed by an anchor whose round trip is at most PACED_US."""
    spans = record["spans"]
    parents = {s["parent"] for s in spans if s["device"]}
    rtt = record["anchor_rtt_us"]
    total = paced = 0.0
    for i, s in enumerate(spans):
        if (not s["device"] or s["step"] < 0 or i in parents
                or rtt[s["anchor"]] > PACED_US):
            continue
        total += _ms(s["device"])
        if (s["device"][1] - s["host"][1]) * 1e3 <= PACED_US:
            paced += _ms(s["device"])
    return 100.0 * paced / total if total else None


def host_ms_p95(record: dict) -> float | None:
    """p95 over control steps of the host ms from entering "step: other"
    to leaving "render: other": the launch path, before the caller's
    synchronise."""
    enter, leave = {}, {}
    for s in record["spans"]:
        if s["step"] < 0:
            continue
        if s["label"] == "step: other":
            enter.setdefault(s["step"], s["host"][0])
        elif s["label"] == "render: other" and s["host"][1] is not None:
            leave[s["step"]] = s["host"][1]
    ms = [leave[st] - t for st, t in enter.items() if st in leave]
    return float(np.percentile(ms, 95)) if ms else None


def step_ms_p95(record: dict) -> float | None:
    """p95 over control steps of the device ms from the step's first
    enter event to the last exit event of "render: other"."""
    first, last = {}, {}
    for s in record["spans"]:
        if s["step"] < 0 or not s["device"]:
            continue
        st = s["step"]
        first[st] = min(first.get(st, s["device"][0]), s["device"][0])
        if s["label"] == "render: other":
            last[st] = max(last.get(st, s["device"][1]), s["device"][1])
    ms = [last[st] - first[st] for st in last]
    return float(np.percentile(ms, 95)) if ms else None


def window_counts(record: dict) -> dict:
    """Each counter summed over the control steps."""
    out: dict = {}
    for step, name, v in record["counts"]:
        if step >= 0:
            out[name] = out.get(name, 0.0) + v
    return out


def capped_pct(record: dict) -> float | None:
    """100 x the env-steps in which one of K3's caps dropped work over the
    env-steps, in the window."""
    c = window_counts(record)
    if not c.get("env_steps"):
        return None
    return 100.0 * c.get("capped_env_steps", 0.0) / c["env_steps"]


def build_resets_s(record: dict) -> float | None:
    """Host seconds in the build's per-episode "reset" spans, summed."""
    ms = [_ms(s["host"]) for s in record["spans"]
          if s["label"] == "reset" and s["host"][1] is not None]
    return sum(ms) / 1e3 if ms else None
