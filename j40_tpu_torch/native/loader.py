"""port: the native core's first load, one thread at a time.

`bindings.get_lib` (a byte-for-byte copy of j40_tpu's) marks the core
tried before it has loaded it, so a thread that asks while another thread
loads it gets None: a decode running on that thread would decode one
channel of a stream in Python and the next natively, and go wrong
(`ans?`).  Every Decoder calls `load_once` before it decodes: the first
call loads the core while the others wait for it, so that from then on
every `get_lib` of every thread returns the same answer."""

from __future__ import annotations

import threading

from . import bindings

_LOCK = threading.Lock()
_loaded = False


def load_once():
    """The native core, or None where it cannot be built or loaded; once it
    returns, `bindings.get_lib` returns the same on every thread."""
    global _loaded
    if not _loaded:
        with _LOCK:
            bindings.get_lib()
            _loaded = True
    return bindings.get_lib()
