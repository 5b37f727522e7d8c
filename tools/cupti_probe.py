"""Where torch.profiler (CUPTI) loses kernel records, on one CUDA card.

    python3 tools/cupti_probe.py [OUT_JSON]

Times one function per probe in profiler sessions of CALLS calls, as
chip_smoke.device_ms does (CPU and CUDA activities), and counts the device
records each session returns.  Probes: B1 (`reconstruct_dct8_srgb`) at the
batch chunk's shape (n = 65,536 blocks, synthetic coefficients as
tests/test_torch_cuda.py makes them), config 3's shape (n = 16,384), and
`torch.matmul` (3n, 64) x (64, 64) at the chunk's n, chip_smoke's
yardstick.  Each probe runs in these conditions, SESSIONS sessions each:

- `fresh`: before anything else has been profiled in the process;
- `marked`: a one-element `add_` (the marker) before every call, so that
  the order of the records shows which calls lost theirs;
- `after_big`: after one session that recorded BIG small launches;
- `settled`: as `after_big`, but each session first runs a short sleep
  kernel (`torch.cuda._sleep`, whose kernel is `spin_kernel`) and waits
  50 ms on the host before its calls (chip_smoke.settle);
- `sleep_kernel_only` and `host_wait_only`: one of the two.

Prints one JSON line (and writes it to OUT_JSON when given): per probe and
condition the records of the probe seen per session (the sleep kernel's
not counted), for `marked` sessions the indices of the calls whose record
is missing, and for the settled conditions whether the sleep kernel's
record was kept.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CALLS = 32
SESSIONS = 4
BIG = 50_000


SLEEP_KERNEL = "spin_kernel"


def session(fn, marker=None, sleep_kernel=False, host_wait=False):
    """One profiler session of CALLS calls of `fn`: the names of its device
    records in start order, the sleep kernel's included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if sleep_kernel:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        if host_wait:
            time.sleep(0.05)
        for _ in range(CALLS):
            if marker is not None:
                marker()
            fn()
        torch.cuda.synchronize()
    recs = sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return [name for _, name in recs]


def count(names):
    """(records other than the sleep kernel's, the sleep kernel's kept)"""
    own = [n for n in names if SLEEP_KERNEL not in n]
    return len(own), len(own) < len(names)


def lost_calls(names, marker_name):
    """Call indices whose record is missing in a marked session: a marker
    record not followed by a record of the probe.  (A lost marker merges
    two calls; such sessions are reported as they are.)"""
    lost, call, i = [], 0, 0
    while i < len(names):
        if names[i] == marker_name:
            if i + 1 >= len(names) or names[i + 1] == marker_name:
                lost.append(call)
                i += 1
            else:
                i += 2
            call += 1
        else:
            i += 1  # a probe record without its marker
            call += 1
    return lost


def probes(dev):
    from j40_tpu_torch.ops import kernels as K

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import _consts22, _inputs

    out = {}
    for name, (h8, w8) in (("b1_chunk", (1024, 64)), ("b1_config3", (128, 128))):
        q, aux, w = (t.to(dev) for t in _inputs(h8, w8))
        c22 = _consts22(255.0).to(dev)
        out[name] = (lambda q=q, aux=aux, w=w, c22=c22, h8=h8, w8=w8:
                     K.reconstruct_dct8_srgb(q, aux, w, c22, h8, w8, True))
    flat = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3 * 65536, 64)).astype(np.float32)).to(dev)
    kt = torch.from_numpy(K.idct8_matrix()).to(dev).T.contiguous()
    out["matmul_chunk"] = lambda: torch.matmul(flat, kt)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("cupti_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fns = probes(dev)
    one = torch.zeros(1, device=dev)

    def marker():
        one.add_(1)

    for fn in fns.values():
        for _ in range(3):
            fn()
    marker_name = session(marker)[0]
    res = {name: {} for name in fns}
    for name, fn in fns.items():
        res[name]["fresh"] = [count(session(fn))[0] for _ in range(SESSIONS)]
    for name, fn in fns.items():
        marked = [session(fn, marker) for _ in range(SESSIONS)]
        res[name]["marked"] = [len(m) for m in marked]
        res[name]["marked_lost_calls"] = [lost_calls(m, marker_name) for m in marked]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(BIG):
            marker()
        torch.cuda.synchronize()
    big_seen = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    for name, fn in fns.items():
        res[name]["after_big"] = [count(session(fn))[0] for _ in range(SESSIONS)]
        for cond, kw in (("settled", dict(sleep_kernel=True, host_wait=True)),
                         ("sleep_kernel_only", dict(sleep_kernel=True)),
                         ("host_wait_only", dict(host_wait=True))):
            got = [count(session(fn, **kw)) for _ in range(SESSIONS)]
            res[name][cond] = [n for n, _ in got]
            if kw.get("sleep_kernel"):
                res[name][cond + "_sleep_record_kept"] = [k for _, k in got]
    line = json.dumps(dict(calls=CALLS, big=BIG, big_seen=big_seen,
                           torch=torch.__version__, card=torch.cuda.get_device_name(0),
                           probes=res))
    print(line)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
