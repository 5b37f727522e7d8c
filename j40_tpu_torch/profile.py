"""The decode's own spans, and torch.profiler around a decode.

Spans.  Every decode records where its time goes in `dec.stats["spans"]`:

    with span(dec.stats, "modular.batch", longest_lane=n) as sp:
        ...

appends one record (name, parent index, start_ns, end_ns, cpu_ns, counts)
a span: the wall clock of `time.time_ns()` (the clock the profiler gives
its device records in, so spans lie over a trace's kernels and copies),
the thread's CPU time inside it (`time.thread_time_ns()`) where the span
asks for it with `cpu=True` (the root `request` and the copies, which a
metric reads: a read of the thread's clock is a system call) and None
elsewhere, and a small dict of integers or None.  A span's parent is the
innermost span open on its thread for the same stats (-1: a root); a span
takes its record's slot when it opens, so a parent's record comes before
its children's.  `span(None, name)` records into the decode whose span is
open on the thread, and records nothing where none is: the copy helpers
`upload`, `fetch` and `scalar` open theirs so, and every blocking copy
between host and device of a decode goes through them.  A decode records
on its own thread and on the pool threads it hands work to: `carry(fn)`
runs `fn` on a worker as if inside the span open on the caller, so the
spans `fn` opens there are that span's children.  `dec.stats["request"]`
is the decode's id, one a Decoder in the process.

Profiling (port: the counterpart of the JAX CLI's `jax.profiler.trace`):

    with trace("prof/", device):
        ...  # the decode

writes one `*.pt.trace.json` (Chrome trace format) into the directory, the
TensorBoard layout JAX's xplane trace also uses.  CPU activity is always
recorded; CUDA activity (the kernels and copies, through CUPTI) when the
device is a CUDA device.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

#: the kernel of torch.cuda._sleep, which settle() launches; a reader of
#: the trace leaves its record out
SETTLE_KERNEL = "spin_kernel"

_REQUESTS = itertools.count(1)
_OPEN = threading.local()
#: a record's slot is taken under it: pool threads append to one decode's
#: records at once
_SLOT = threading.Lock()


def request_id() -> int:
    """A new decode's id, unique in the process."""
    return next(_REQUESTS)


def clock(cpu: bool = False) -> tuple[int, int]:
    """(wall ns, then the thread's CPU ns where `cpu`, else 0) now: a span's
    `start`."""
    return time.time_ns(), time.thread_time_ns() if cpu else 0


class span:
    """A span of a decode's work (see the module's docstring).  `start`, a
    `clock()` read earlier on the same thread (with `cpu` where the span
    has it), backdates it.  `start_ns` is its record's start once it is
    open; `end_ns` and `seconds` its end and length once it has closed."""

    __slots__ = ("spans", "name", "parent", "cpu", "counts", "index", "start",
                 "start_ns", "end_ns")

    def __init__(self, stats: dict | None, name: str, start=None, cpu: bool = False,
                 **counts):
        self.spans = None if stats is None else stats.setdefault("spans", [])
        self.name = name
        self.start = start
        self.cpu = cpu
        self.counts = counts
        self.parent = self.index = -1
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> span:
        try:
            stack = _OPEN.stack
        except AttributeError:
            stack = _OPEN.stack = []
        if self.spans is None:
            if not stack:
                return self  # no decode records on this thread
            self.spans = stack[-1].spans
        if stack and stack[-1].spans is self.spans:
            self.parent = stack[-1].index
        with _SLOT:
            self.index = len(self.spans)
            self.spans.append(None)
        stack.append(self)
        if self.start is None:
            self.start = clock(self.cpu)
        self.start_ns = self.start[0]
        return self

    def __exit__(self, *exc) -> bool:
        if self.index < 0:
            return False
        # the CPU clock read inside the wall clock's reads at both ends, and
        # held to the wall time: two clocks
        cpu = time.thread_time_ns() if self.cpu else None
        end = time.time_ns()
        if cpu is not None:
            cpu = min(cpu - self.start[1], end - self.start_ns)
        _OPEN.stack.pop()
        self.end_ns = end
        self.spans[self.index] = (self.name, self.parent, self.start_ns, end, cpu,
                                  self.counts or None)
        return False


def carry(fn):
    """`fn` for pool threads: the spans it opens there record into the
    decode whose span is open on the calling thread now, as children of
    that span; `fn` itself where none is open."""
    stack = getattr(_OPEN, "stack", None)
    if not stack:
        return fn
    top = stack[-1]  # a worker's stack holds it below its own spans

    def in_span(*args):
        mine = getattr(_OPEN, "stack", None)
        if mine is None:
            mine = _OPEN.stack = []
        mine.append(top)
        try:
            return fn(*args)
        finally:
            mine.pop()

    return in_span


def upload(x, device):
    """`x`, a numpy array, on `device`: a blocking copy from pageable host
    memory, in a `copy.htod` span."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x))
    with span(None, "copy.htod", cpu=True):
        return t.to(device)


def fetch(t):
    """A device tensor's values in pageable host memory: a blocking copy,
    in a `copy.dtoh` span."""
    with span(None, "copy.dtoh", cpu=True):
        return t.cpu()


def scalar(t):
    """A device tensor's one value as a Python number (`item()`: a blocking
    copy through pinned host memory), in a `copy.dtoh` span."""
    with span(None, "copy.dtoh", cpu=True):
        return t.item()


def span_lines(spans: list) -> list[str]:
    """One line a span, `name  ms  self-ms`, indented by its depth: the self
    time is the span's less the union of its children's."""
    kids: dict[int, list] = {}
    for i, s in enumerate(spans):
        if s is not None:
            kids.setdefault(s[1], []).append(i)
    lines: list[str] = []

    def walk(i: int, depth: int) -> None:
        name, _, t0, t1, _, _ = spans[i]
        covered, end = 0, t0
        for a, b in sorted((spans[k][2], spans[k][3]) for k in kids.get(i, ())):
            a, b = max(a, end), min(b, t1)
            if b > a:
                covered += b - a
                end = b
        lines.append(f"{'  ' * depth}{name}  {(t1 - t0) * 1e-6:.3f}  "
                     f"{(t1 - t0 - covered) * 1e-6:.3f}")
        for k in kids.get(i, ()):
            walk(k, depth + 1)

    for root in kids.get(-1, ()):
        walk(root, 0)
    return lines


def settle() -> None:
    """The start of a CUDA profiler session.  After one session of many
    records (a decode's profile), CUPTI lost records at the start of every
    later session, and a short sleep kernel and 50 ms on the host before
    the first traced call kept them all (tools/cupti_probe.py)."""
    import torch

    torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize()
    time.sleep(0.05)


@contextlib.contextmanager
def trace(log_dir, device: torch.device | None):
    """Profile the block; on its exit write the trace into `log_dir`.
    `device` is the decode's device (None: a host-only decode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = device is not None and device.type == "cuda"
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        if cuda:
            with torch.cuda.device(device):
                settle()
        yield prof
