"""Typed simulator events + JSONL trace serialization.

Every state change the simulator makes — workload arrivals, kubelet
lifecycle transitions, fault injections — and every effect it observes from
the scheduler (bind/evict acks) is a `SimEvent`. Applied events append to a
`TraceRecorder` as canonical JSONL lines; the SHA-256 over those lines is
the run's trace hash, the determinism contract (`--seed N` twice ⇒ identical
hash, byte-identical trace files). A recorded trace replays: `read_trace` +
the workload module's trace-driven generator re-inject the same arrivals.

Event payloads are JSON primitives only (no object references) so a trace
line is self-contained and replayable across processes.

Mirrors ``kube_batch_tpu/sim/events.py`` line for line: the two packages
write byte-identical traces for the same run, so their ``trace_sha256``
receipts compare directly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterator, List

# ---- event kinds ----------------------------------------------------------
# injected (scheduled on the heap, applied by the runner)
JOB_ARRIVAL = "job-arrival"          # podgroup + gang pods enter the cluster
POD_RUNNING = "pod-running"          # kubelet started a bound pod
POD_SUCCEEDED = "pod-succeeded"      # kubelet finished a running pod
POD_FAILED = "pod-failed"            # pod lost (node crash fallout)
EVICT_TERMINATED = "evict-terminated"  # eviction grace period elapsed
JOB_COMPLETE = "job-complete"        # all pods succeeded; objects collected
# faults (applied through sim/faults.py)
NODE_CRASH = "node-crash"
NODE_READD = "node-readd"
BIND_FAIL = "bind-fail"              # next N binder calls fail (resync path)
WATCH_FLAP = "watch-flap"            # watch reconnect: full MODIFIED replay
BROWNOUT = "apiserver-brownout"      # every egress call fails for a window
BROWNOUT_END = "brownout-end"
LEADER_FAILOVER = "leader-failover"  # leadership lost; warm standby takes over
CORRUPT = "resident-corrupt"         # flip a word in a resident DEVICE column
# observed (recorded from scheduler effects, never scheduled)
BIND = "bind"
EVICT = "evict"

FAULT_KINDS = frozenset({NODE_CRASH, NODE_READD, BIND_FAIL, WATCH_FLAP,
                         BROWNOUT, BROWNOUT_END, LEADER_FAILOVER, CORRUPT})


@dataclasses.dataclass
class SimEvent:
    """One simulator event: virtual timestamp, kind, JSON-primitive data."""

    time: float
    kind: str
    data: Dict = dataclasses.field(default_factory=dict)


def event_line(event: SimEvent, seq: int) -> str:
    """Canonical single-line JSON for the trace: sorted keys, compact
    separators, time rounded to microsecond-of-virtual-time — byte-stable
    across runs of the same seed."""
    rec = {"seq": seq, "t": round(event.time, 6), "kind": event.kind}
    rec.update(event.data)
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


class TraceRecorder:
    """Append-only record of applied/observed events, hashable and
    writable as JSONL."""

    def __init__(self):
        self.lines: List[str] = []

    def record(self, event: SimEvent) -> None:
        self.lines.append(event_line(event, len(self.lines)))

    def sha256(self) -> str:
        h = hashlib.sha256()
        for line in self.lines:
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for line in self.lines:
                f.write(line + "\n")

    def __len__(self) -> int:
        return len(self.lines)


def read_trace(path: str) -> Iterator[SimEvent]:
    """Parse a JSONL trace back into events (trace-driven replay)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            t = rec.pop("t")
            kind = rec.pop("kind")
            rec.pop("seq", None)
            yield SimEvent(time=t, kind=kind, data=rec)
