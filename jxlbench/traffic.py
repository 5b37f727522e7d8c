"""The traffic of a cell: its workload file's "traffic" block names a loop,
`{"loop": NAME, ...}`, which jxlbench/loops/NAME.py runs (a new kind of
traffic is a new file there).  A request is one corpus item: client c of C
walks the corpus from item c * n / C on.  Every request started in the
window is waited for, up to `GRACE_S` past its close; one that does
not come back by then, or raises, has failed.
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from dataclasses import dataclass, field

GRACE_S = 60.0


@dataclass
class Request:
    client: int
    seq: int
    item: int
    due: float = 0.0
    end: float = math.inf
    ok: bool = False
    error: str = ""
    stats: dict = field(default_factory=dict)
    answer: object = None


def picker(corpus: int, clients: int):
    """pick(client, seq) -> the corpus item of that request."""
    return lambda c, k: (c * corpus // clients + k) % corpus


def drive(call, traffic: dict, corpus: int, seconds: float, keep,
          during=None) -> tuple[list[Request], float, float]:
    """Run the traffic for `seconds` through `call(item) -> (answer, stats)`.
    `keep(request) -> bool` says whether the answer is kept for the check;
    `during(t0, t1)`, if given, runs in its own thread while the window is
    open.  Returns every request and the window's ends (perf_counter)."""
    from jxlbench import spec

    loop = spec.load_module(spec.PKG / "loops" / f"{traffic['loop']}.py")
    pick = picker(corpus, loop.clients(traffic))
    reqs: list[Request] = []
    lock = threading.Lock()

    def send(client: int, seq: int, item: int, due: float) -> None:
        r = Request(client, seq, item, due=due)
        with lock:
            reqs.append(r)
        try:
            r.answer, r.stats = call(r.item)
            r.ok = True
        except Exception:  # a failed request is counted, never fatal to the run
            r.error = traceback.format_exc(limit=4)
        r.end = time.perf_counter()
        if not (r.ok and keep(r)):
            r.answer = None

    t0 = time.perf_counter() + 0.05
    t1 = t0 + seconds
    threads = loop.threads(traffic, pick, send, t0, t1)
    side = threading.Thread(target=during, args=(t0, t1), daemon=True) if during else None
    for th in threads:
        th.start()
    if side:
        side.start()
    for th in threads:
        th.join(timeout=max(0.0, t1 + GRACE_S - time.perf_counter()))
    if side:
        side.join(timeout=max(0.0, t1 + GRACE_S - time.perf_counter()))
    with lock:
        done = list(reqs)
    for r in done:
        if r.end == math.inf and not r.error:
            r.error = "no answer within the grace period"
    return done, t0, t1
