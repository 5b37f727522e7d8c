"""The readers of the program's spans on made-up requests and a made-up
slice with known answers: two requests that overlap in time, one without
any copy, a request that failed, idle stretches with and without a client
in the program; the device clock fitted to the spans' from the copies;
and nothing read from a program that records no spans."""

from types import SimpleNamespace

import pytest

from jxlbench import spans, spec, traffic
from jxlbench.spans import CPU
from jxlbench.trace import Slice

#: the clock's origin of the made-up records, ns since the epoch
BASE = 1_790_000_000 * 10**9
READERS = ["modular_plan_ms.tiles", "copy_wait_ms.tiles", "finish_ms.tiles", "render_ms.tiles",
           "host_offcpu_ms.tiles", "idle_in_host_ms.tiles", "B6_ns_per_symbol"]


def ns(ms: float) -> int:
    return BASE + round(ms * 1e6)


def sec(ms: float) -> float:
    return ns(ms) * 1e-9


def rec(name, parent, t0, t1, cpu=0.0, **counts):
    return (name, parent, ns(t0), ns(t1), round(cpu * 1e6), counts or None)


def request(recs, ok=True, end=1.0):
    r = traffic.Request(0, 0, 0, ok=ok, end=end)
    r.stats = {"request": 1, "spans": recs} if recs is not None else {}
    return r


def reader(name):
    return spec.load_module(spec.PKG / "metrics" / f"{name}.py")


# request A: 0-100 ms, 60 ms on a core, two copies (30 ms, 7 ms of it on a core)
A = [rec("request", -1, 0, 100, 60), rec("modular.plan", 0, 2, 5),
     rec("modular.batch", 0, 8, 80, longest_lane=1000),
     rec("copy.htod", 2, 10, 20, 5),
     rec("copy.dtoh", 2, 50, 70, 2),
     rec("finish", 0, 80, 90), rec("render", 0, 90, 98)]
# request B: 40-140 ms, overlapping A, 80 ms on a core, no copy
B = [rec("request", -1, 40, 140, 80), rec("modular.plan", 0, 45, 49),
     rec("modular.batch", 0, 50, 120, longest_lane=3000),
     rec("finish", 0, 120, 126), rec("render", 0, 126, 130)]
# request C failed: its host work counts in the slice, not in the means
C = [rec("request", -1, 150, 160, 10), rec("finish", 0, 150, 151)]
# the device: B6 15-45 and 100-125 (each after its setup kernel), a fetch 50-70
DEVICE = [("tokens_serial_setup<true>", sec(14), sec(15)),
          ("tokens_serial_kernel<true>", sec(15), sec(45)),
          ("Memcpy DtoH (Device -> Pageable)", sec(50), sec(70)),
          ("tokens_serial_setup<true>", sec(99), sec(100)),
          ("tokens_serial_kernel<true>", sec(100), sec(125))]


def ctx(reqs, slice_=True, device=DEVICE):
    sl = Slice(t0=sec(0), t1=sec(200), device=list(device), launches={"tokens": 2})
    return SimpleNamespace(requests=reqs, t1=2.0, per_request={"tokens": 1},
                           slice=sl if slice_ else None)


@pytest.mark.parametrize("name,want", [
    ("modular_plan_ms.tiles", (3 + 4) / 2),
    ("copy_wait_ms.tiles", (30 + 0) / 2),
    ("finish_ms.tiles", (10 + 6) / 2),
    ("render_ms.tiles", (8 + 4) / 2),
    # A: (100 - 30) - (60 - 7) = 17; B: 100 - 80 = 20
    ("host_offcpu_ms.tiles", (17 + 20) / 2),
    # idle 0-14, 45-50, 70-99, 125-200; in the program 0-10, 20-50, 70-100
    # (A), 40-140 (B), 150-160 (C): 10 + 5 + 29 + 15 + 10 over 2 requests
    ("idle_in_host_ms.tiles", (10 + 5 + 29 + 15 + 10) / 2),
    # 27.5 ms a record over a mean longest lane of 2000 symbols
    ("B6_ns_per_symbol", 27.5e6 / 2000),
])
def test_each_reader(name, want):
    got = reader(name).read(ctx([request(A), request(B), request(C, ok=False)]))
    assert got == pytest.approx(want, rel=1e-5)  # epoch seconds hold ~0.2 us


def test_a_gap_with_no_client_in_the_program():
    """Idle stretches no request's host work covers read nothing: with only
    request B (40-140), the idle 45-50, 70-99 and 125-140 ms count."""
    got = reader("idle_in_host_ms.tiles").read(ctx([request(B)]))
    assert got == pytest.approx((5 + 29 + 15) / 2, rel=1e-5)


def test_idle_in_host_with_the_device_clock_off():
    """Device records 3 ms late on the spans' clock: the fit of the fetch's
    Memcpy record to its `copy.dtoh` span takes them back, and the reader
    reads what it reads on one clock (A and B in the program: 10 + 5 + 29 +
    15 ms of idle over 2 requests)."""
    late = [(n, s + 3e-3, e + 3e-3) for n, s, e in DEVICE]
    got = reader("idle_in_host_ms.tiles").read(ctx([request(A), request(B)], device=late))
    assert got == pytest.approx((10 + 5 + 29 + 15) / 2, rel=1e-5)
    sl = ctx([], device=late).slice
    fit = spans.clock_fit(sl, A + B)
    assert fit["b"] == 0 and fit["a"] == pytest.approx(-3e-3, abs=1e-6)
    assert fit["held"] == fit["records"] == 1


def test_the_clock_fit_finds_an_offset_and_a_drift():
    """Copies of two clients over 2 s, each Memcpy record 20 us inside its
    span on the spans' clock, then moved to a device clock 1.2 ms behind it
    and drifting 100 us a second: the fit puts every record back in its
    span, and moves every time to within its `bound` of the truth."""
    t0 = sec(0)
    reqs, device = [], []
    for c in range(2):
        recs = [rec("request", -1, 0, 2000)]
        for k in range(40):
            lo = 10 + 50 * k + 20 * c  # the two clients' copies overlap
            recs.append(rec("copy.htod" if k % 3 else "copy.dtoh", 0, lo, lo + 12))
            a, b = sec(lo + 0.02), sec(lo + 12 - 0.02)
            device.append(("Memcpy HtoD (Pageable -> Device)" if k % 3 else
                           "Memcpy DtoH (Device -> Pageable)", a, b))
        reqs += recs
    a0, b0 = 1.2e-3, -1e-4  # the device clock: t - a0 - b0 (t - t0), to first order
    moved = [(n, s - a0 - b0 * (s - t0), e - a0 - b0 * (e - t0)) for n, s, e in device]
    sl = Slice(t0=t0, t1=sec(2000), device=moved, launches={})
    fit = spans.clock_fit(sl, reqs)
    assert fit["held"] == fit["records"] == len(device)
    # the records' 20 us of room each side, and a drift step (10 us a
    # second) over the 2 s
    assert fit["bound"] < 2 * 20e-6 + 1e-5 * 2
    for t in (0.0, 2.0):
        assert abs(fit["a"] + fit["b"] * t - (a0 + b0 * t)) <= fit["bound"] + 1e-6
    back = spans.shifted(sl, fit)
    for (_, s, e), (_, s0, e0) in zip(back, device):
        assert abs(s - s0) <= fit["bound"] + 1e-6 and abs(e - e0) <= fit["bound"] + 1e-6
    assert spans.clock_fit(sl, [r for r in reqs if not r[0].startswith("copy.")]) is None


def test_copies_split_the_requests_host_stretches():
    assert spans.in_program(A) == [pytest.approx((sec(0), sec(10))),
                                   pytest.approx((sec(20), sec(50))),
                                   pytest.approx((sec(70), sec(100)))]
    assert spans.in_program(B) == [pytest.approx((sec(40), sec(140)))]
    assert spans.merge([(3, 4), (0, 2), (1, 3.5), (6, 6)]) == [(0, 4)]
    assert spans.overlap([(0, 4), (6, 9)], [(3, 7), (8, 10)]) == 3


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_spans(name):
    """The program without spans (stats without "spans"), or no slice, reads
    None and does not raise."""
    assert reader(name).read(ctx([request(None), request(None)])) is None
    if name == "host_offcpu_ms.tiles":  # a request span that read no CPU time
        assert reader(name).read(ctx([request([A[0][:CPU] + (None,) + A[0][CPU + 1:]])])) is None
    if name in ("idle_in_host_ms.tiles", "B6_ns_per_symbol"):
        assert reader(name).read(ctx([request(A)], slice_=False)) is None
