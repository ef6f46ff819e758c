"""A profiled stretch of a run's window, as the per-layer readers see it.

`profile(run_units)` traces the calls `run_units()` makes with
torch.profiler (host and device activities), kept in memory, and returns a
`Trace`: every device operation (kernels, copies, fills) with its interval,
the kernels among them, and the host's events (the benchmark's spans and the
program's operators). The stretch's window is from the start of its first
device operation to the end of its last; the device is busy where any
operation runs.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."


def base_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    or parameters: "void ns::spectral_chain_kernel<float, 4>(...)" ->
    "spectral_chain_kernel"."""
    name = name.replace("(anonymous namespace)", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    head = head.split(" ")[-1]
    return head.split("::")[-1]


@dataclass
class Trace:
    """Intervals in microseconds on the profiler's clock."""
    ops: list = field(default_factory=list)      # (name, start, end), every device op
    kernels: list = field(default_factory=list)  # (name, start, end), kernels alone
    host: list = field(default_factory=list)     # (name, start, end), host events
    units: int = 0          # train steps or forecast batches in the stretch
    batches: list = field(default_factory=list)  # the batch size of each unit

    @property
    def start(self) -> float:
        return min(s for _, s, _ in self.ops)

    @property
    def end(self) -> float:
        return max(e for _, _, e in self.ops)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some device operation runs (the union of the
        operations' intervals)."""
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def gaps(self) -> list:
        """(start, end) of each interval inside the window where no device
        operation runs."""
        out, cur_e = [], None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out

    def kernel_seconds(self, pattern: str | None = None, exclude=()) -> float:
        """Seconds of the kernels whose base name fully matches `pattern`
        (every kernel where None) and none of `exclude`."""
        total = 0.0
        for name, s, e in self.kernels:
            base = base_name(name)
            if pattern is not None and not re.fullmatch(pattern, base):
                continue
            if any(re.fullmatch(p, base) for p in exclude):
                continue
            total += e - s
        return total * 1e-6

    def count(self, patterns) -> Counter:
        """Launches by base name of the kernels that match one of `patterns`."""
        return Counter(b for b in (base_name(n) for n, _, _ in self.kernels)
                       if any(re.fullmatch(p, b) for p in patterns))

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the benchmark's span that holds
        it and the innermost other host event that holds it."""
        span, inner, inner_start = None, None, None
        for name, s, e in self.host:
            if s <= t <= e:
                if name.startswith(SPAN_PREFIX):
                    span = name
                elif inner_start is None or s >= inner_start:
                    inner, inner_start = name, s
        parts = [p for p in (span, inner) if p]
        return " > ".join(parts) if parts else "no host event"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name) and the
        longest idle gaps by what the host was doing in them."""
        by_name = Counter()
        for name, s, e in self.ops:
            by_name[name[:160]] += (e - s) * 1e-6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
                "idle_gaps": [[self.host_at(0.5 * (s + e)), (e - s) * 1e-6] for s, e in gaps]}


def profile(run_units) -> Trace:
    """Trace what run_units() runs (it ends with the device idle: the caller
    synchronizes inside). Raises RuntimeError where the profiler records no
    device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run_units()
    trace = Trace()
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if ev.is_user_annotation:
                continue
            trace.ops.append((ev.name, start, end))
            if not ev.name.startswith(("Memcpy", "Memset")):
                trace.kernels.append((ev.name, start, end))
        else:
            trace.host.append((ev.name, start, end))
    if not trace.kernels:
        raise RuntimeError("the profiler recorded no kernel")
    return trace
