"""The traced window: a ``torch.profiler`` session and what is read from it.

Device activity is every record the profiler files under the CUDA device
(kernels, copies, sets). ``busy_s`` is the length of their union, so
overlapping records count once. The benchmark's own spans around its calls
into the index are ``record_function`` ranges named ``palmbench.<kind>``;
they share the trace's clock, so an idle gap on the device is named by the
span the host was in and the host operator that covered most of the gap.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

# the port's hand-written kernels as the profiler names them, by the
# ``kernels.ops.LAUNCHES`` counter that counts their launches
KERNELS = {"screen_select": ("screen_dense_kernel",),
           "screen_select_quant": ("screen_quant_kernel",),
           "topk_ed": ("topk_ed_kernel",),
           "paa": ("paa_kernel",), "sax_pack": ("sax_pack_kernel",),
           "min_ed": ("min_ed_kernel", "min_ed_unpack_kernel"),
           "mindist": ("mindist_kernel",)}
SPAN_PREFIX = "palmbench."


@dataclasses.dataclass
class Summary:
    window_s: float  # wall length of the traced window
    busy_s: float  # union of device records
    device_ops: list  # [(name, seconds)], most time first
    idle_gaps: list  # [(what the host did, seconds)], most idle first
    kernel_s: dict  # kernel name fragment -> seconds, for the KERNELS names
    short: dict  # LAUNCHES key -> (records, launches) where records fell short


def start(torch, device):
    """A profiling session of the host and the card, the card synchronized
    (on the CPU, of the host alone)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop(torch, prof, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)


def _union(intervals):
    """Merged (start, end) pairs of sorted-or-not intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events, t_open_ns: int, t_close_ns: int, top: int = 10) -> Summary:
    """Reduce raw events (name, is_device, start_ns, end_ns) of one window."""
    dev, host, spans = [], [], []
    by_name = collections.Counter()
    for name, is_device, a, b in events:
        if is_device and name.startswith(SPAN_PREFIX):
            continue  # the span's copy on the device timeline: no activity
        if is_device:
            a, b = max(a, t_open_ns), min(b, t_close_ns)
            if b > a:
                dev.append((a, b))
                by_name[name] += (b - a) / 1e9
        elif name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):]))
        else:
            host.append((a, b, name))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, last = [], t_open_ns
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t_close_ns > last:
        gaps.append((last, t_close_ns))
    spans.sort()
    host.sort()
    span_starts = [s for s, _, _ in spans]
    host_starts = [s for s, _, _ in host]
    idle = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        j = bisect.bisect_right(span_starts, mid) - 1
        span = spans[j][2] if j >= 0 and spans[j][1] >= mid else "between calls"
        # the host operator covering most of the gap (those that start in
        # it, and the last few that started before it), if one covers half
        i0 = bisect.bisect_left(host_starts, a)
        i1 = bisect.bisect_left(host_starts, b)
        best, best_overlap = "host code outside torch", 0
        for s, e, n in host[max(0, i0 - 8):i1]:
            ov = min(e, b) - max(s, a)
            if ov > best_overlap and 2 * ov >= b - a:
                best, best_overlap = n, ov
        idle[f"{span}: {best}"] += (b - a) / 1e9
    kernel_s = {frag: sum(s for n, s in by_name.items() if frag in n)
                for frags in KERNELS.values() for frag in frags}
    return Summary(
        window_s=(t_close_ns - t_open_ns) / 1e9, busy_s=busy_s,
        device_ops=[[n, s] for n, s in by_name.most_common(top)],
        idle_gaps=[[n, s] for n, s in idle.most_common(top)],
        kernel_s=kernel_s, short={},
    )


def read(prof, t_open_ns: int, t_close_ns: int, launches: dict) -> Summary:
    """Summarize a finished session and count its kernel records against
    the launches the wrappers counted (F5: a process that has worked for
    minutes can lose device records; a short count marks the trace)."""
    events, counts = [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        is_device = str(e.device_type()).endswith("CUDA")
        name = e.name()
        a = e.start_ns()
        events.append((name, is_device, a, a + e.duration_ns()))
        if is_device and not name.startswith(SPAN_PREFIX):
            for k, frags in KERNELS.items():
                counts[k] += sum(frag in name for frag in frags)
    s = summarize(events, t_open_ns, t_close_ns)
    s.short = {k: (counts[k], n * len(KERNELS[k])) for k, n in launches.items()
               if n and counts[k] < n * len(KERNELS[k])}
    return s
