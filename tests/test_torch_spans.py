"""The decode's spans (`j40_tpu_torch/profile.py`): the small Modular
streams of tests/test_torch_modular_fused.py through `decode_file(...,
backend="device", device="cpu")`, the entry the benchmark drives.

Checked: the span tree (every child inside its parent, one root `request`
a decode, a request id a Decoder, the names of the route's layers and
the counts: each B6 launch's longest lane, the request's stream), the
stage clocks equal to their spans' lengths, the boundaries of the Modular
route's `setup_s` / `scan_fetch_s` / `write_s` (what runs inside each), a
torch.profiler session on the spans' clock, and concurrent decodes on their own threads
each recording only into their own spans.
"""

import threading
import time

import pytest
import torch
from test_torch_modular_fused import STREAMS, _stream

from j40_tpu_torch import profile as P
from j40_tpu_torch.decode import decode_file
from j40_tpu_torch.ops import device_modular as DM

NAME, PARENT, START, END, CPU, COUNTS = range(6)
#: every span a Modular decode on the device route records
NAMES = {"request", "headers", "sections", "modular.plan", "modular.batch", "modular.setup",
         "modular.pack", "copy.htod", "copy.dtoh", "modular.write", "finish", "render"}
#: one stream of each lane kind: single leaf, static-property tree, neighbour tree
KINDS = ["modular", "modular_static_ctx", "modular_e3gt"]


def _decode(name):
    data = _stream(name)
    dec, rgba = decode_file(data, backend="device", device="cpu")
    return data, dec, dec.stats["spans"]


def _named(spans, name):
    return [s for s in spans if s[NAME] == name]


def _secs(s):
    return (s[END] - s[START]) * 1e-9


@pytest.mark.parametrize("name", list(STREAMS))
def test_span_tree_and_stage_clocks(name, monkeypatch):
    longest = []  # the longest lane of each batch the route packs for B6

    def pack(lanes):
        longest.append(max(ln.nsym for ln in lanes))
        return pack_lanes(lanes)

    pack_lanes = DM.pack_lanes
    monkeypatch.setattr(DM, "pack_lanes", pack)
    data, dec, spans = _decode(name)
    st = dec.stats
    assert "peak_rss_mb" not in st
    assert all(s is not None for s in spans)
    assert {s[NAME] for s in spans} == NAMES
    roots = [s for s in spans if s[PARENT] == -1]
    assert [r[NAME] for r in roots] == ["request"]
    for i, s in enumerate(spans):
        if s[NAME] == "request" or s[NAME].startswith("copy."):
            assert 0 <= s[CPU] <= s[END] - s[START], s
        else:
            assert s[CPU] is None, s
        if s[PARENT] >= 0:
            p = spans[s[PARENT]]
            assert s[PARENT] < i and p[START] <= s[START] <= s[END] <= p[END], (s, p)
    parents = {s[NAME]: spans[s[PARENT]][NAME] for s in spans if s[PARENT] >= 0}
    assert parents["modular.plan"] == parents["modular.batch"] == "sections"
    assert parents["modular.setup"] == parents["modular.write"] == "modular.batch"
    assert parents["modular.pack"] == "modular.setup"
    assert parents["headers"] == parents["finish"] == parents["render"] == "request"
    for c in _named(spans, "copy.htod") + _named(spans, "copy.dtoh"):
        assert spans[c[PARENT]][NAME] in ("modular.setup", "modular.batch")

    # the one count: the longest lane of each B6 launch, a batch's
    dm = st["device_modular"]
    batches = _named(spans, "modular.batch")
    assert [b[COUNTS] for b in batches] == [{"longest_lane": n} for n in longest]
    assert 0 < max(longest) and sum(longest) <= dm["tokens"]
    # and the request's stream: 0, the caller's, on the CPU
    assert [s[COUNTS] for s in _named(spans, "request")] == [{"stream": 0}]
    assert all(s[COUNTS] is None for s in spans
               if s[NAME] not in ("modular.batch", "request"))

    # the stage clocks are their spans' lengths
    (hd,), (sec,), (fin,) = (_named(spans, n) for n in ("headers", "sections", "finish"))
    assert st["headers_s"] == _secs(hd)
    assert st["sections_s"] == _secs(sec)
    assert st["reconstruct_s"] == _secs(fin)
    assert st["total_s"] == (fin[END] - hd[START]) * 1e-9
    setups, writes = _named(spans, "modular.setup"), _named(spans, "modular.write")
    assert len(setups) == len(writes) == len(batches)
    assert dm["setup_s"] == pytest.approx(
        sum((s[END] - b[START]) * 1e-9 for s, b in zip(setups, batches)), rel=1e-12)
    assert dm["scan_fetch_s"] == pytest.approx(
        sum((w[START] - s[END]) * 1e-9 for s, w in zip(setups, writes)), rel=1e-12)
    assert dm["write_s"] == pytest.approx(sum(_secs(w) for w in writes), rel=1e-12)


@pytest.mark.parametrize("name", KINDS)
def test_modular_clock_boundaries(name, monkeypatch):
    """`setup_s` is the packing, the uploads and the token launch;
    `scan_fetch_s` the unpack, the wavefronts, the range check and the one
    fetch; `write_s` the lane end checks and the write-back."""
    seen: dict[str, list] = {}

    def stamp(key, fn):
        def wrapped(*a, **kw):
            t0 = time.time_ns()
            out = fn(*a, **kw)
            seen.setdefault(key, []).append((t0, time.time_ns()))
            return out
        return wrapped

    monkeypatch.setattr(DM, "pack_lanes", stamp("pack", DM.pack_lanes))
    monkeypatch.setattr(DM.TKN, "launch_tokens", stamp("launch", DM.TKN.launch_tokens))
    monkeypatch.setattr(DM, "unpack_signed_dev", stamp("unpack", DM.unpack_signed_dev))
    monkeypatch.setattr(DM, "_range_check", stamp("range", DM._range_check))
    monkeypatch.setattr(DM, "_check_lane_end", stamp("end", DM._check_lane_end))
    _, _, spans = _decode(name)
    batches = _named(spans, "modular.batch")
    setups, writes = _named(spans, "modular.setup"), _named(spans, "modular.write")
    fetches = [c for c in _named(spans, "copy.dtoh") if spans[c[PARENT]][NAME] == "modular.batch"]
    assert len(fetches) == len(batches) == len(seen["launch"]) > 0

    def inside(key, lo, hi):
        return [a for a, b in seen[key] if lo <= a and b <= hi]

    for b, s, w, f in zip(batches, setups, writes, fetches):
        assert len(inside("pack", b[START], s[END])) == len(inside("launch", b[START], s[END])) == 1
        assert s[END] <= f[START] and f[END] <= w[START]
        assert inside("unpack", s[END], f[START]) and inside("range", s[END], f[START])
        assert inside("end", w[START], w[END])
    assert sum(len(inside(k, s[END], w[START])) for k in ("unpack", "range")
               for s, w in zip(setups, writes)) == len(seen["unpack"]) + len(seen["range"])


def test_request_ids_and_the_profilers_clock():
    """One id a Decoder; a torch.profiler CPU record opened inside a span
    lies inside it (the spans are on the profiler's clock)."""
    _, a, _ = _decode("modular")
    _, b, _ = _decode("modular")
    assert isinstance(a.stats["request"], int) and a.stats["request"] != b.stats["request"]
    from torch.profiler import ProfilerActivity, profile, record_function

    stats: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span(stats, "outer") as sp:
            with record_function("inside_span"):
                time.sleep(0.002)
            torch.ones(8).sum()
    evs = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside_span"]
    assert len(evs) == 1
    e = evs[0]
    assert sp.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= sp.end_ns


def test_a_span_of_no_decode_and_the_clis_lines():
    """A span opened where no decode records (`span(None, ...)` with no
    span open on the thread) records nothing; the CLI's lines give each
    span's length and self time, indented by depth."""
    stats: dict = {}
    with P.span(None, "copy.dtoh") as orphan:
        pass
    assert orphan.index == -1
    with P.span(stats, "request", start=P.clock(cpu=True), cpu=True):
        assert P.scalar(torch.tensor(7)) == 7
        with P.span(stats, "finish"):
            time.sleep(0.001)
        time.sleep(0.001)
    spans = stats["spans"]
    assert [(s[NAME], s[PARENT]) for s in spans] == [("request", -1), ("copy.dtoh", 0),
                                                    ("finish", 0)]
    assert spans[0][CPU] is not None and spans[1][CPU] is not None and spans[2][CPU] is None
    lines = P.span_lines(spans)
    assert [ln.split()[0] for ln in lines] == ["request", "copy.dtoh", "finish"]
    assert lines[1].startswith("  copy.dtoh  ") and lines[2].startswith("  finish  ")
    total, self_ms = map(float, lines[0].split()[1:])
    assert total >= 2.0 and 1.0 <= self_ms < total


def test_concurrent_decodes_keep_their_own_spans():
    """Decodes on three threads at once, as the benchmark's clients run
    (the interpreter switches threads many times in a decode): each
    decode's copies and spans land in its own records, every record closed,
    in the tree of a lone decode."""
    _, alone, _ = _decode("modular")
    want = [(s[NAME], s[PARENT]) for s in alone.stats["spans"]]
    out: dict[int, object] = {}

    def client(i):
        out[i] = _decode("modular")[1]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert len({d.stats["request"] for d in out.values()}) == 3
    for d in out.values():
        spans = d.stats["spans"]
        assert None not in spans and [(s[NAME], s[PARENT]) for s in spans] == want


def test_carried_spans_from_many_threads_keep_their_slots():
    """Pool threads that record into one decode (`profile.carry`), more of
    them than cores and switching often: every span gets a slot of its
    own, closes in it, and is a child of the span open on the caller."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    stats: dict = {}
    n, each = 2 * (os.cpu_count() or 4), 300

    def work(k):
        for i in range(each):
            with P.span(None, "work", k=k, i=i):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.span(stats, "request"), P.span(None, "sections") as sections:
            with ThreadPoolExecutor(n) as ex:
                futures = [ex.submit(P.carry(work), k) for k in range(n)]
                for f in futures:
                    f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    spans = stats["spans"]
    assert len(spans) == 2 + n * each and None not in spans
    work_spans = [s for s in spans if s[NAME] == "work"]
    assert {s[PARENT] for s in work_spans} == {sections.index}
    assert sorted((s[COUNTS]["k"], s[COUNTS]["i"]) for s in work_spans) == \
        [(k, i) for k in range(n) for i in range(each)]
    # a thread with nothing carried records nothing
    ThreadPoolExecutor(1).submit(work, 0).result(timeout=60)
    assert len(stats["spans"]) == 2 + n * each
