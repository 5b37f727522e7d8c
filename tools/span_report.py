"""What the files of tools/span_trace.py show: whether the program's spans
share the device trace's clock, where the device's idle time falls, and
where a request's time goes on the host.

    python3 tools/span_report.py FILE.json [FILE.json ...]

For each file, one JSON line:
- `clock_fit`: the device records' clock fitted to the spans' (the slice's
  Memcpy records against the copy spans, which pair one to one:
  `jxlbench.spans.clock_fit`): offset `a_us` at the slice's start, drift
  `b_us_per_s`, records held inside a span of their direction, and
  `bound_us`, the most another fit that holds as many moves a time;
- `b6_in_batch`: the share of the slice's `tokens_serial_kernel` records
  that start inside some request's `modular.batch` span;
- `htod_in_span`, `dtoh_in_span`: the share of its `Memcpy HtoD` / `DtoH`
  records that lie inside some request's `copy.htod` / `copy.dtoh` span;
  these three after the fit, and `raw` before it;
- `copy_spans`, `memcpy_records`: copy spans and Memcpy records that start
  in the slice, each direction, and a tile (over the requests' worth of
  work the slice holds, the benchmark's `requests_in_slice`);
- `idle_ms_a_tile`: the slice's device idle time a tile (after the fit) by
  the innermost span of the clients that covers it, an instant's idle
  time split evenly among the clients in a request there; "(no request)"
  where none is; `idle_ms_a_tile_error`, each row's largest change when
  the device records move by `bound_us` either way;
- `host_ms_a_tile`: each span's mean wall and self time a completed
  request, ms.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from jxlbench import arith, spans  # noqa: E402
from jxlbench.spans import END, NAME, PARENT, START  # noqa: E402
from jxlbench.trace import Slice  # noqa: E402


def _inside(t0: float, t1: float, ivs: list) -> bool:
    return any(a <= t0 and t1 <= b for a, b in ivs)


def _depths(spans: list) -> list[int]:
    d = []
    for s in spans:
        d.append(0 if s[PARENT] < 0 else d[s[PARENT]] + 1)
    return d


def _idle_by_span(dev: list, t0: float, t1: float, reqs: list) -> dict[str, float]:
    """The slice's idle seconds by the innermost span of the clients there."""
    busy = [(max(s, t0), min(e, t1)) for _, s, e in dev if e > t0 and s < t1]
    idle = arith.gaps(busy, t0, t1)
    cover = []  # (start, end, depth, name, request) of every span near the slice
    for ri, r in enumerate(reqs):
        for s, d in zip(r["spans"], _depths(r["spans"])):
            a, b = s[START] * 1e-9, s[END] * 1e-9
            if b > t0 and a < t1:
                cover.append((a, b, d, s[NAME], ri))
    cuts = sorted({x for a, b in idle for x in (a, b)}
                  | {x for a, b, *_ in cover for x in (a, b) if t0 < x < t1})
    by_name: dict[str, float] = defaultdict(float)
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        if not any(ia <= mid <= ib for ia, ib in idle):
            continue
        inner: dict[int, tuple] = {}
        for ca, cb, d, name, ri in cover:
            if ca <= mid < cb and (ri not in inner or d > inner[ri][0]):
                inner[ri] = (d, name)
        if not inner:
            by_name["(no request)"] += b - a
        for d, name in inner.values():
            by_name[name] += (b - a) / len(inner)
    return by_name


def _shares(dev: list, t0: float, t1: float, secs) -> dict:
    batches, htod, dtoh = secs("modular.batch"), secs("copy.htod"), secs("copy.dtoh")
    in_slice = [(n, s, e) for n, s, e in dev if t0 <= s <= t1]
    b6 = [(s, e) for n, s, e in in_slice if "tokens_serial_kernel" in n]
    hd = [(s, e) for n, s, e in in_slice if n.startswith("Memcpy HtoD")]
    dh = [(s, e) for n, s, e in in_slice if n.startswith("Memcpy DtoH")]
    share = lambda xs, ok: (sum(ok(x) for x in xs) / len(xs)) if xs else None
    return {"b6_in_batch": share(b6, lambda x: any(a <= x[0] <= b for a, b in batches)),
            "htod_in_span": share(hd, lambda x: _inside(x[0], x[1], htod)),
            "dtoh_in_span": share(dh, lambda x: _inside(x[0], x[1], dtoh))}


def report(path: Path) -> dict:
    kept = json.loads(path.read_text())
    sl = kept["slice"]
    t0, t1 = sl["t0"], sl["t1"]
    raw = [(n, s, e) for n, s, e in sl["device"]]
    reqs = [r for r in kept["requests"] if r["spans"]]
    fit = spans.clock_fit(Slice(t0=t0, t1=t1, device=raw, launches=sl["launches"]),
                          [s for r in reqs for s in r["spans"] if s is not None])

    def moved(da: float) -> list:
        f = None if fit is None else dict(fit, a=fit["a"] + da)
        return spans.shifted(Slice(t0=t0, t1=t1, device=raw), f)

    dev = moved(0.0)

    def secs(name: str) -> list:
        return [(s[START] * 1e-9, s[END] * 1e-9) for r in reqs for s in r["spans"]
                if s[NAME] == name]

    in_slice = [(n, s, e) for n, s, e in dev if t0 <= s <= t1]
    hd = [n for n, _, _ in in_slice if n.startswith("Memcpy HtoD")]
    dh = [n for n, _, _ in in_slice if n.startswith("Memcpy DtoH")]
    per = kept["per_request"].get("tokens", 0)
    setups = [n for n, _, _ in in_slice if "tokens_serial_setup" in n or "tokens_sync_setup" in n]
    tiles = len(setups) / per if per else None
    out = {
        "file": path.name,
        "result": {k: v["value"] for k, v in kept["result"]["metrics"].items()},
        "tiles_in_slice": tiles,
        "clock_fit": None if fit is None else {
            "a_us": 1e6 * fit["a"], "b_us_per_s": 1e6 * fit["b"], "held": fit["held"],
            "records": fit["records"], "bound_us": 1e6 * fit["bound"]},
        **_shares(dev, t0, t1, secs),
        "raw": _shares(raw, t0, t1, secs),
        "copy_spans": {"htod": sum(t0 <= a <= t1 for a, _ in secs("copy.htod")),
                       "dtoh": sum(t0 <= a <= t1 for a, _ in secs("copy.dtoh"))},
        "memcpy_records": {"htod": len(hd), "dtoh": len(dh)},
    }
    if tiles:
        out["copy_spans_a_tile"] = {k: v / tiles for k, v in out["copy_spans"].items()}
        out["memcpy_records_a_tile"] = {k: v / tiles for k, v in out["memcpy_records"].items()}
        by_name = _idle_by_span(dev, t0, t1, reqs)
        out["idle_ms_a_tile"] = {k: 1e3 * v / tiles for k, v in
                                 sorted(by_name.items(), key=lambda kv: -kv[1])}
        out["idle_ms_a_tile_total"] = 1e3 * sum(by_name.values()) / tiles
        if fit is not None:
            ends = [_idle_by_span(moved(d), t0, t1, reqs) for d in (-fit["bound"], fit["bound"])]
            out["idle_ms_a_tile_error"] = {
                k: 1e3 * max(abs(e.get(k, 0.0) - by_name.get(k, 0.0)) for e in ends) / tiles
                for k in set(by_name) | {k for e in ends for k in e}}

    # each span's mean wall and self time a completed request
    done = [r for r in reqs if r["ok"]]
    wall: dict[str, float] = defaultdict(float)
    own: dict[str, float] = defaultdict(float)
    for r in done:
        sp = r["spans"]
        kids = defaultdict(list)
        for s in sp:
            kids[s[PARENT]].append(s)
        for i, s in enumerate(sp):
            wall[s[NAME]] += s[END] - s[START]
            covered = arith.union((c[START], c[END]) for c in kids[i])
            own[s[NAME]] += s[END] - s[START] - covered
    out["host_ms_a_tile"] = {k: [1e-6 * wall[k] / len(done), 1e-6 * own[k] / len(done)]
                             for k in wall}
    return out


def main(argv=None) -> int:
    for p in (argv or sys.argv[1:]):
        print(json.dumps(report(Path(p))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
