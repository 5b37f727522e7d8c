"""The native core's first load (j40_tpu_torch/native/loader.py): threads
that ask for it while it loads wait for the load, so no decode sees None
for one channel and the core for the next."""

import threading
import time

from j40_tpu_torch.native import bindings, loader


def _fresh(monkeypatch, delay: float):
    """A process in which the core has not been loaded yet, whose load
    takes `delay` seconds."""
    real = bindings.ctypes.CDLL

    def slow(*a, **kw):
        time.sleep(delay)
        return real(*a, **kw)

    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_tried", False)
    monkeypatch.setattr(bindings.ctypes, "CDLL", slow)
    monkeypatch.setattr(loader, "_loaded", False)


def _ask(fn, n=8):
    """What `fn` returns on each of n threads started together."""
    seen = [None] * n
    go = threading.Barrier(n)

    def one(i):
        go.wait()
        seen[i] = fn()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return seen


def test_threads_wait_for_the_first_load(monkeypatch):
    assert bindings.get_lib() is not None
    _fresh(monkeypatch, 0.5)

    def after_load_once():
        loader.load_once()
        return bindings.get_lib()

    seen = _ask(after_load_once)
    assert all(s is not None for s in seen) and len({id(s) for s in seen}) == 1


def test_get_lib_alone_races_the_first_load(monkeypatch):
    """Why load_once exists: get_lib alone gives None to the threads that
    ask while another loads the core."""
    assert bindings.get_lib() is not None
    _fresh(monkeypatch, 0.5)
    seen = _ask(bindings.get_lib)
    assert any(s is None for s in seen) and any(s is not None for s in seen)


def test_every_decoder_loads_the_core_first(monkeypatch):
    from j40_tpu_torch import decode

    calls = []
    monkeypatch.setattr(decode, "load_once", lambda: calls.append(1))
    try:
        decode.Decoder(b"", backend="numpy")
    except Exception:
        pass
    assert calls == [1]
