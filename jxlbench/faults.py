"""Broken timed paths, for the tests that show a run of such a path come
out not correct.  Each wraps the entry: fault(entry, items) -> call, where
call(data) -> (answer, stats) as the entry's."""

from __future__ import annotations


def _one_block(answer):
    """A copy of the answer with one 8x8 block of its first channel wrong,
    as one altered token leaves it: each sample's bit 6 flipped."""
    out = answer.copy()
    out[:8, :8, 0] ^= 0x40
    return out


def altered(entry, items):
    """An answer altered where it is produced: one block of samples wrong."""
    def call(data):
        answer, stats = entry(data)
        return _one_block(answer), stats
    return call


def stale(entry, items):
    """The answer of another request: each request decodes the corpus item
    after its own."""
    order = {id(it.data): k for k, it in enumerate(items)}

    def call(data):
        return entry(items[(order[id(data)] + 1) % len(items)].data)
    return call


def control_of(cell, seed: int, device):
    """The control of `correct`: the configuration's plain reference at the
    precision below the stated one (its module's `control`), put in the
    program's place.  Each corpus item's answer is worked out once."""
    from jxlbench import corpus

    def fault(entry, items):
        order = {id(it.data): k for k, it in enumerate(items)}
        done: dict = {}

        def one(k):
            if k not in done:
                img = corpus.image(cell, seed, k)
                done[k] = cell.codec.control(img, cell.config, device=device)
            return done[k]

        def call(data):
            return one(order[id(data)]).cpu().numpy(), {}
        return call
    return fault
