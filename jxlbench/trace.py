"""The device trace of a slice of the measured window (torch.profiler, CUPTI).

A controller thread opens a profiler session (device activity only, so the
host pays no per-call recording) while the clients keep running, settles it
(CUPTI lost records at the start of a session that followed a busy one,
unless a short sleep kernel and ~50 ms on the host came first), reads the
program's launch counters at both ends of the slice, samples the other
threads' stacks meanwhile, and synchronises before the end, so that every
kernel launched inside the slice has finished inside it.  The slice's ends
are wall-clock times, the clock the profiler gives device records in.  A slice whose
kernel records are fewer than the launches counted in it lost records: it
is thrown away and another one is taken; a run whose slices all lost
records says so and reads no device metric from them.
"""

from __future__ import annotations

import collections
import re
import sys
import threading
import time
from dataclasses import dataclass, field

from jxlbench import arith

#: the kernel of torch.cuda._sleep, which the settling launches
SETTLE_KERNEL = "spin_kernel"
#: each of the program's launch counters (ops/kernels.launches) and the
#: kernel that every one of its launches runs exactly once
MARKERS = {
    "reconstruct_dct8_srgb": "dct8_kernel", "reconstruct_dct8": "dct8_kernel",
    "xyb_to_srgb": "xyb_kernel", "hf": ("hf_structure_kernel", "hf_ans_kernel"),
    "hf_ctx": "hf_ctx_kernel", "tokens": ("tokens_serial_setup", "tokens_sync_setup"),
    "wavefront": "plain_wavefront_kernel", "wavefront_mixed": "plain_wavefront_kernel",
    "wavefront_wp": "wp_wavefront_kernel", "wavefront_wp_codes": "wp_wavefront_kernel",
    "wavefront_tree": "wp_wavefront_kernel", "unsqueeze": "unsqueeze_",
    "gaborish": "gaborish_kernel", "epf_step": "epf_step_kernel", "epf_fused": "epf_fused_kernel",
}


def matches(name: str, keys) -> bool:
    keys = (keys,) if isinstance(keys, str) else keys
    return any(k in name for k in keys)


@dataclass
class Slice:
    t0: float                      # the slice's ends in the trace's clock, seconds
    t1: float
    device: list = field(default_factory=list)   # (name, start, end) seconds
    samples: list = field(default_factory=list)  # (time, where a host thread was)
    launches: dict = field(default_factory=dict)
    lost: str | None = None

    def records(self, keys) -> list:
        """Device records of the kernels named by `keys` that start in the slice."""
        return [r for r in self.device if matches(r[0], keys) and self.t0 <= r[1] <= self.t1]

    def seconds(self, keys) -> float:
        return sum(e - s for _, s, e in self.records(keys))

    def busy(self) -> float:
        return arith.union((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device
                           if e > self.t0 and s < self.t1)

    def check(self) -> None:
        """Set `lost` where the records of a counted kernel are fewer than
        its launches counted in the slice."""
        for counter, n in self.launches.items():
            if n <= 0 or counter not in MARKERS:
                continue
            same = [c for c in MARKERS if MARKERS[c] == MARKERS[counter]]
            want = sum(self.launches.get(c, 0) for c in same)
            got = len(self.records(MARKERS[counter]))
            if got < want:
                self.lost = f"{counter}: {got} records of {want} launches"
                return
        if not self.device:
            self.lost = "no device records"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by where the host threads were most often in it."""
        by_name: dict[str, float] = {}
        for name, s, e in self.records(""):
            by_name[short(name)] = by_name.get(short(name), 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = [(max(s, self.t0), min(e, self.t1)) for _, s, e in self.device
                 if e > self.t0 and s < self.t1]
        longest = sorted(arith.gaps(spans, self.t0, self.t1), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_label(a, b), b - a] for a, b in longest]}

    def host_label(self, a: float, b: float) -> str:
        seen = collections.Counter(w for t, w in self.samples if a <= t <= b)
        return "host: " + (seen.most_common(1)[0][0] if seen else "no thread in the program")


def short(name: str) -> str:
    """A kernel's name without its namespace, template and argument lists."""
    name = re.sub(r"\(anonymous namespace\)::", "", name).removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def _events(prof):
    """(name, start_s, end_s) of every device record of the session."""
    from torch.autograd import DeviceType

    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                yield e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
    except AttributeError:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                yield e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6


def where(frame) -> str | None:
    """The innermost frame of the program on a thread's stack, as
    `module:function`; None for a thread outside the program (idle)."""
    while frame is not None:
        name = frame.f_code.co_filename
        if "j40_tpu_torch" in name:
            mod = name[name.rindex("j40_tpu_torch"):].removesuffix(".py").replace("/", ".")
            return f"{mod}:{frame.f_code.co_name}"
        frame = frame.f_back
    return None


def init() -> None:
    """Open and close one profiler session on the calling thread.  Run it on
    the main thread before any slice: a first session opened on another
    thread recorded no device activity (CUPTI's init callback must run on
    the thread that registered the client)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def take(seconds: float, counters, device, every: float = 0.005) -> Slice:
    """Profile the device for `seconds` of whatever the process runs
    meanwhile, and sample every `every` seconds where the other threads are
    on the host (their stacks), to name the device's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    me = threading.get_ident()
    samples: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize(device)
        time.sleep(0.05)
        t0 = time.time()
        c0 = dict(counters())
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            now = time.time()
            for tid, frame in sys._current_frames().items():
                w = where(frame) if tid != me else None
                if w is not None:
                    samples.append((now, w))
            time.sleep(every)
        c1 = dict(counters())
        torch.cuda.synchronize(device)
        t1 = time.time()
    sl = Slice(t0=t0, t1=t1, samples=samples,
               launches={k: c1.get(k, 0) - c0.get(k, 0) for k in c1})
    sl.device = [r for r in _events(prof) if SETTLE_KERNEL not in r[0]]
    sl.check()
    return sl
