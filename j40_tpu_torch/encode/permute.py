"""Lehmer-code permutation encoding (dual of headers.frame.read_permutation,
reference j40.h:5428-5472).

Used to emit permuted TOCs and custom HF coefficient orders — decoder paths
that plain encoders never exercise.
"""

from __future__ import annotations

from ..io.bits import ceil_lg
from .entropy import EntropyEncoder


def lehmer_encode(perm: list[int], skip: int = 0) -> list[int]:
    """Lehmer code such that apply_permutation(target, code) reorders target
    into [target[skip + p] for p in perm] at positions skip..skip+len(perm).

    perm indexes into the post-skip region; trailing identity is trimmed.
    """
    n = len(perm)
    remaining = list(range(n))
    lehmer = []
    for want in perm:
        x = remaining.index(want)
        lehmer.append(x)
        remaining.pop(x)
    while lehmer and lehmer[-1] == 0:
        lehmer.pop()
    return lehmer


def add_permutation_tokens(
    enc: EntropyEncoder, lehmer: list[int], size: int, skip: int, stream: int = 0
) -> None:
    """Emit the permutation token stream (end count + offsets) with the
    decoder's context chain (j40.h:5437-5449)."""
    end = len(lehmer)
    enc.add(min(7, ceil_lg(size + 1)), end, stream)
    prev = 0
    for x in lehmer:
        enc.add(min(7, ceil_lg(prev + 1)), x, stream)
        prev = x
