"""What the serving pipeline's per-layer metrics read: the program's spans
(`enhanced_unet_tpu_torch.utils.profiler`), recorded in this process while
the traced window's profiler ran, laid over the window's device operations
(`harness.TraceView`).  Each metric's file under `metrics/` names one of
these.  Each gives None where the program recorded no spans (a program
without them), or where the window's root spans are not one a request."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from portbench.harness import union_seconds

ROOT = "serve.request"
FORWARD = "model.forward"


def recorded() -> List[dict]:
    """The spans the program recorded, or [] for a program that records
    none."""
    from enhanced_unet_tpu_torch.utils import profiler

    read = getattr(profiler, "spans", None)
    return read() if read is not None else []


def requests(t, spans: Optional[List[dict]] = None):
    """The window's root request spans and, by root id, the `device_ms` of
    their forwards; None unless there is one root a request."""
    spans = recorded() if spans is None else spans
    roots = [s for s in spans if s["parent"] is None and s["name"] == ROOT]
    if not roots or len(roots) != t.counts.get("requests"):
        return None
    forwards: Dict[int, List[float]] = {r["id"]: [] for r in roots}
    for s in spans:
        if s["name"] == FORWARD and s["root"] in forwards:
            forwards[s["root"]].append(s["device_ms"])
    return roots, forwards


def pipeline_ms(t, spans=None):
    """The mean over the window's requests of the root span's `device_ms`
    less its forwards': the request's device time outside the network."""
    got = requests(t, spans)
    if got is None:
        return None
    roots, forwards = got
    return sum(r["device_ms"] - sum(forwards[r["id"]]) for r in roots) / len(roots)


def forward_ms(t, spans=None):
    """The mean over the window's requests of their forwards' `device_ms`."""
    got = requests(t, spans)
    if got is None:
        return None
    roots, forwards = got
    return sum(sum(f) for f in forwards.values()) / len(roots)


def innermost(spans: List[dict]):
    """A function from a host time (ns) to the innermost closed span whose
    host interval holds it, or None."""
    closed = sorted((s for s in spans if s["end_ns"] is not None),
                    key=lambda s: s["start_ns"])
    by_id = {s["id"]: s for s in closed}
    starts = [s["start_ns"] for s in closed]

    def find(t):
        i = bisect.bisect_right(starts, t) - 1
        # spans nest: the latest to start before t holds it, or one of its
        # ancestors does, or none
        s = closed[i] if i >= 0 else None
        while s is not None and s["end_ns"] < t:
            s = by_id.get(s["parent"])
        return s
    return find


def gaps(ops, lo: int, hi: int) -> List[tuple]:
    """(start_ns, end_ns) of the times in [lo, hi] that none of `ops`
    ((name, start_ns, end_ns)) covers."""
    out, end = [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if hi > end:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(ops, spans: List[dict]) -> Dict[Optional[str], float]:
    """ms of the gaps between `ops` over the spans' extent by the innermost
    span whose host interval holds the gap's middle (None: no span)."""
    closed = [s for s in spans if s["end_ns"] is not None]
    if not closed:
        return {}
    find = innermost(closed)
    out: Dict[Optional[str], float] = {}
    for a, b in gaps(ops, min(s["start_ns"] for s in closed), max(s["end_ns"] for s in closed)):
        s = find((a + b) // 2)
        name = None if s is None else s["name"]
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def program_idle_ms(t, spans=None):
    """ms a request of the device's idle gaps that fall inside a span of
    the program: idle its own host code leaves, not the caller's between
    requests.  The gaps are those between the window's kernels; copies are
    no kernels, and the view gives them only as a total (its busy time less
    the kernels' union), which is taken off: the program makes each copy of
    a request (upload, download) inside one of its spans."""
    spans = recorded() if spans is None else spans
    got = requests(t, spans)
    if got is None:
        return None
    in_spans = sum(v for k, v in idle_by_span(t.kernels, spans).items() if k is not None)
    copies_ms = (t.busy_s - union_seconds(t.kernels)) * 1e3
    return (in_spans - copies_ms) / len(got[0])
