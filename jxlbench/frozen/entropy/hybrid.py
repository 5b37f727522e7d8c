"""Hybrid integer coding (reference j40.h:2277-2329, spec §13.2.2).

A token below 2^split_exp is the value itself; otherwise the token encodes
(exponent, msb, lsb) and the middle bits are read raw from the bitstream.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import J40Error
from ..io.bits import BitReader


@dataclass(frozen=True)
class HybridIntConfig:
    split_exp: int
    msb_in_token: int
    lsb_in_token: int

    @property
    def max_token(self) -> int:
        # largest token whose decoded value stays below 2^30 (j40.h:2308)
        return (
            (1 << self.split_exp)
            + ((30 - self.split_exp) << (self.lsb_in_token + self.msb_in_token))
            - 1
        )


def read_hybrid_int_config(r: BitReader, log_alpha_size: int) -> HybridIntConfig:
    split_exp = r.at_most(log_alpha_size)
    if split_exp != log_alpha_size:
        msb = r.at_most(split_exp)
        lsb = r.at_most(split_exp - msb)
    else:
        msb = lsb = 0
    return HybridIntConfig(split_exp, msb, lsb)


def read_hybrid_int(r: BitReader, token: int, cfg: HybridIntConfig) -> int:
    split = 1 << cfg.split_exp
    if token < split:
        return token
    if token > cfg.max_token:
        raise J40Error("iovf", f"token {token} exceeds 2^30 bound")
    bits_in_token = cfg.msb_in_token + cfg.lsb_in_token
    midbits = cfg.split_exp - bits_in_token + ((token - split) >> bits_in_token)
    mid = r.u(midbits)
    top = 1 << cfg.msb_in_token
    lo = token & ((1 << cfg.lsb_in_token) - 1)
    hi = (token >> cfg.lsb_in_token) & (top - 1)
    return ((top | hi) << (midbits + cfg.lsb_in_token)) | (mid << cfg.lsb_in_token) | lo


def encode_hybrid_int(value: int, cfg: HybridIntConfig) -> tuple[int, int, int]:
    """Encoder dual: value -> (token, midbits, mid).

    Inverse of read_hybrid_int; midbits raw bits of `mid` follow the token.
    """
    split = 1 << cfg.split_exp
    if value < split:
        return value, 0, 0
    n = value.bit_length() - 1  # position of the leading 1
    lsb = value & ((1 << cfg.lsb_in_token) - 1)
    msb = (value >> (n - cfg.msb_in_token)) & ((1 << cfg.msb_in_token) - 1)
    bits_in_token = cfg.msb_in_token + cfg.lsb_in_token
    midbits = n - bits_in_token
    token = split + (
        ((n - cfg.split_exp) << bits_in_token)
        | (msb << cfg.lsb_in_token)
        | lsb
    )
    mid = (value >> cfg.lsb_in_token) & ((1 << midbits) - 1)
    return token, midbits, mid
