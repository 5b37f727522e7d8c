"""The closed loop: {"loop": "closed", "clients": C}.  C client
threads, each sending its next request when its last one has returned; a
request is timed from when it was sent."""

from __future__ import annotations

import threading
import time


def threads(traffic: dict, pick, send, t0: float, t1: float) -> list:
    """The loop's threads, not started.  `send(client, seq, item, due)`
    records and serves one request."""
    def client(c: int) -> None:
        while time.perf_counter() < t0:
            time.sleep(0.001)
        k = 0
        while (now := time.perf_counter()) < t1:
            send(c, k, pick(c, k), now)
            k += 1

    return [threading.Thread(target=client, args=(c,), daemon=True)
            for c in range(traffic["clients"])]


def clients(traffic: dict) -> int:
    return traffic["clients"]
