"""torch.profiler around a decode (port: the counterpart of the JAX CLI's
`jax.profiler.trace`).

    with trace("prof/", device):
        ...  # the decode

writes one `*.pt.trace.json` (Chrome trace format) into the directory, the
TensorBoard layout JAX's xplane trace also uses.  CPU activity is always
recorded; CUDA activity (the kernels and copies, through CUPTI) when the
device is a CUDA device.
"""

from __future__ import annotations

import contextlib
import time

import torch

#: the kernel of torch.cuda._sleep, which settle() launches; a reader of
#: the trace leaves its record out
SETTLE_KERNEL = "spin_kernel"


def settle() -> None:
    """The start of a CUDA profiler session.  After one session of many
    records (a decode's profile), CUPTI lost records at the start of every
    later session, and a short sleep kernel and 50 ms on the host before
    the first traced call kept them all (tools/cupti_probe.py)."""
    torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize()
    time.sleep(0.05)


@contextlib.contextmanager
def trace(log_dir, device: torch.device | None):
    """Profile the block; on its exit write the trace into `log_dir`.
    `device` is the decode's device (None: a host-only decode)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = device is not None and device.type == "cuda"
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        if cuda:
            with torch.cuda.device(device):
                settle()
        yield prof
