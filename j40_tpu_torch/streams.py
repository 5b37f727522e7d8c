"""The CUDA streams a decode runs on.

`decode_file` and `decode_animation` run each decode on a stream of the
decoding thread's own (`own_stream`): the blocking copies of one thread's
decode then wait only for the work that decode queued, and the kernels of
decodes on several threads run at once on the card.  A thread keeps its
stream for its life, one a device (`thread_stream`): the caching allocator
keeps freed blocks a stream, so a thread's later decodes reuse its blocks.
A decode on the CPU takes no stream.

`Decoder` itself runs on its caller's current stream, and its worker
threads on that stream too (`carry`): batch serving and the sharded paths
order their copies on the streams they find.

Device tensors that decodes on several streams read (the caches of
constant tables, the W3 tree: `device_cache`) are made by blocking copies,
so they are whole before a reader can see them; each read marks the
reader's stream on its tensor (`shared`), so a cache that evicts or
replaces an entry frees its block only after the work that stream queued
before the free.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading

_LOCAL = threading.local()
_INDEX = itertools.count(1)


def thread_stream(device):
    """(stream, index): this thread's own stream on the CUDA `device`, made
    by its first call on the thread and kept; the index numbers streams 1,
    2, ... in the order they are made in the process."""
    import torch

    mine = getattr(_LOCAL, "streams", None)
    if mine is None:
        mine = _LOCAL.streams = {}
    got = mine.get(device)
    if got is None:
        got = mine[device] = (torch.cuda.Stream(device), next(_INDEX))
    return got


@contextlib.contextmanager
def own_stream(device):
    """Run the block on this thread's own stream of `device`, a resolved
    torch device, and yield its index; on any device but CUDA (or None: a
    host decode) run it on the caller's stream and yield 0."""
    if device is None or device.type != "cuda":
        yield 0
        return
    import torch

    s, index = thread_stream(device)
    with torch.cuda.stream(s):
        yield index


def carry(fn, device):
    """`fn` for worker threads: it runs on the calling thread's current
    stream of `device` (a worker starts on its own default stream); `fn`
    itself where `device` is not a CUDA device."""
    if device is None or device.type != "cuda":
        return fn
    import torch

    s = torch.cuda.current_stream(device)

    def on_stream(*args):
        with torch.cuda.stream(s):
            return fn(*args)

    return on_stream


def shared(t):
    """`t`, a cached device tensor that decodes on several streams read:
    its block is not reused before the work the current stream queues on
    it now (`record_stream`; a CPU tensor as it is)."""
    if t.is_cuda:
        import torch

        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def device_cache(maxsize):
    """`functools.lru_cache(maxsize)` for a function that makes a device
    tensor by a blocking copy, whose every read is `shared`."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize)(fn)

        @functools.wraps(fn)
        def read(*args):
            return shared(cached(*args))

        read.cache_clear = cached.cache_clear
        return read

    return wrap
