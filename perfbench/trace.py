"""The device trace of a traced run, and what the readers take from it.

In a ``--trace 1`` run the window runs as in any run; after it the
client goes on for :data:`STEPS` engine steps under ``torch.profiler``
(CPU and CUDA activity), each step inside a ``perfbench.step.<n>``
annotation, ``n`` the step's index in the client's record.  The chrome
trace is written to the run's temporary directory, read back and
removed.  From it come:

* ``window_s``: from the first traced step's start to the last one's end;
* ``busy_s``: the union of device operations (kernels, copies, sets)
  inside that span;
* the device time of each kernel name, and of the kernels of each step
  kind;
* the kernels each step launched (a kernel belongs to the step whose
  annotation holds the host call that launched it);
* the idle gaps between device operations, summed by what the host was
  doing when each began (the innermost host event open at its start; a
  gap that begins outside every engine step is the client's).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

STEPS = 24
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
STEP_PREFIX = "perfbench.step."
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict          # kernel name -> device seconds in the window
    kind_kernel_s: dict     # step kind -> {kernel name: seconds}
    launches: dict          # step index -> kernels it launched
    steps: list             # indices of the traced steps, in order
    idle_by_host: dict      # host activity -> idle seconds


class Tracer:
    """Starts the profiler when the client's traced phase begins and
    stops it when that phase ends."""

    def __init__(self, tmpdir: str | None = None):
        self.tmpdir = tmpdir or tempfile.gettempdir()
        self.prof = None
        self.path = None

    def annotate(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def on_phase(self, phase: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        if phase == "trace" and self.prof is None:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif phase in ("drain", "end") and self.prof is not None \
                and self.path is None:
            self.prof.__exit__(None, None, None)
            fd, self.path = tempfile.mkstemp(prefix="perfbench-trace-",
                                             suffix=".json", dir=self.tmpdir)
            os.close(fd)
            self.prof.export_chrome_trace(self.path)
            self.prof = None

    def summary(self, step_kinds: dict) -> Summary | None:
        if self.path is None:
            return None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)
            self.path = None
        return summarize(events, step_kinds)


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def summarize(events: list, step_kinds: dict) -> Summary | None:
    """Read a chrome trace's events; ``step_kinds`` maps a traced step's
    index to its kind ("decode" | "prefill").  None when no step of the
    client ran under the profiler."""
    steps = []
    for e in _x(events, ("user_annotation",)):
        if e["name"].startswith(STEP_PREFIX):
            idx = int(e["name"][len(STEP_PREFIX):])
            if idx in step_kinds:
                steps.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                              idx))
    if not steps:
        return None
    steps.sort()
    lo, hi = steps[0][0], max(s[1] for s in steps)
    starts = [s[0] for s in steps]

    def step_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= steps[i][1]:
            return steps[i][2]
        return None

    launch_ts = {}
    host = []
    for e in _x(events, HOST_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if e["cat"] in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_ts[corr] = float(e["ts"])
        if not (e["cat"] == "user_annotation"
                and e["name"].startswith(STEP_PREFIX)):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]))
    host.sort()
    host_starts = [h[0] for h in host]

    device = []
    kernel_s = defaultdict(float)
    kind_kernel_s = defaultdict(lambda: defaultdict(float))
    launches = defaultdict(int)
    for e in _x(events, DEVICE_CATS):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if t1 <= lo or t0 >= hi:
            continue
        device.append((max(t0, lo), min(t1, hi)))
        if e["cat"] != "kernel":
            continue
        name = e["name"][:NAME_CHARS]
        dur = (min(t1, hi) - max(t0, lo)) / 1e6
        kernel_s[name] += dur
        corr = (e.get("args") or {}).get("correlation")
        idx = step_at(launch_ts[corr]) if corr in launch_ts else None
        if idx is not None:
            launches[idx] += 1
            kind_kernel_s[step_kinds[idx]][name] += dur
    device.sort()
    busy, idle = 0.0, defaultdict(float)
    cur0 = cur1 = lo
    for t0, t1 in device + [(hi, hi)]:
        if t0 > cur1:
            busy += cur1 - cur0
            idle[_host_at(host, host_starts, cur1, step_at, step_kinds)] += \
                (t0 - cur1) / 1e6
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return Summary(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                   kernel_s=dict(kernel_s),
                   kind_kernel_s={k: dict(v)
                                  for k, v in kind_kernel_s.items()},
                   launches=dict(launches), steps=[s[2] for s in steps],
                   idle_by_host=dict(idle))


def _host_at(host, host_starts, t, step_at, step_kinds) -> str:
    """The innermost host event open at time t, with its step's kind."""
    idx = step_at(t)
    where = f" [{step_kinds[idx]}]" if idx is not None else ""
    i = bisect.bisect_right(host_starts, t) - 1
    for j in range(i, max(-1, i - 256), -1):
        if host[j][1] >= t:
            return host[j][2][:NAME_CHARS] + where
    return ("host in engine.step" + where if idx is not None
            else "client, between engine steps")


def breakdown(summary: Summary) -> dict:
    """The result line's ``breakdown``: the ten kernels that took most
    device time and the ten host activities under most idle time."""
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
