"""Key hashing: 64-bit partition and bucket ids, and the 32-bit mixing
of the join sketch's Bloom bitmask.

Counterpart of ``presto_tpu/ops/hashing.py``. The 64-bit half
(``mix64``, ``hash_columns``, ``partition_ids``, ``bucket_ids``) is a
splitmix64 finalizer chain; bucket ids decide which host spill unit a row
lands in, and so the order of a grouped join's output, so they are
bit-identical to the JAX package's. PyTorch has no general uint64
arithmetic, so the unsigned 64-bit values are held in int64 two's
complement: a product wraps as the unsigned one does, every right shift
is masked back to a logical shift, a modulus is taken on the unsigned
value from its two 32-bit halves, and a narrower integer key widens as
``astype(uint64)`` does (sign-extended).

The 32-bit half (``mix32``, ``mix32_slots``, ``SKETCH_SEED``,
``bloom_build``, ``bloom_test``) is the murmur3 finalizer over each key's
low 32 bits, and a two-hash Bloom bitmask packed 32 bits to an int32
word. The sketch kernel (``csrc/join_probe.cu``) recomputes the same two
slots, so the builder here and the kernel must agree bit for bit.

Bits: a key is first reduced to int32 as the JAX package's
``astype(int32)`` does (int8/int16 sign-extend, wider keys keep their low
32 bits), then mixed as an unsigned 32-bit value. PyTorch has no uint32
arithmetic, so the value is held in int64: a product of two values under
2^32 may wrap the int64, but its low 32 bits are exact, and only those
are kept. Results are int32 (the same bit patterns as the JAX package's
wrapping int32 arithmetic).
"""

from __future__ import annotations

import torch


def _u64(v: int) -> int:
    """The int64 holding the unsigned 64-bit constant ``v``."""
    return v - (1 << 64) if v >= 1 << 63 else v


_M1 = _u64(0xBF58476D1CE4E5B9)
_M2 = _u64(0x94D049BB133111EB)
_GOLDEN = _u64(0x9E3779B97F4A7C15)
_BUCKET_SEED = _u64(0xA24BAED4963EE407)
#: the largest modulus ``partition_ids`` / ``bucket_ids`` take: the
#: half-product ``(hi % n) * (2^32 % n)`` must stay inside int64
MAX_MODULUS = (1 << 31) - 1


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an unsigned 64-bit value held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: uint64 -> uint64 (held in int64)."""
    x = x.to(torch.int64)
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def hash_columns(columns) -> torch.Tensor:
    """Combined 64-bit hash (int64 bits) of one or more integer key
    columns: h = mix(h * GOLDEN ^ mix(col)), order-sensitive. A column
    narrower than 64 bits widens sign-extended (int8/16/32) or
    zero-extended (bool, uint8), as ``astype(uint64)`` does."""
    h = None
    for c in columns:
        hc = mix64(c.to(torch.int64))
        h = hc if h is None else mix64((h * _GOLDEN) ^ hc)
    return h


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``U % n`` of the unsigned value ``U`` of int64 bits ``h``,
    from its 32-bit halves: ((hi % n) * (2^32 % n) + lo) % n."""
    if not 1 <= n <= MAX_MODULUS:
        raise ValueError(f"modulus must be in [1, {MAX_MODULUS}], got {n}")
    hi = _shr(h, 32)
    lo = h & 0xFFFFFFFF
    return (((hi % n) * ((1 << 32) % n) + lo) % n).to(torch.int32)


def partition_ids(columns, num_partitions: int) -> torch.Tensor:
    """Hash-partition assignment in [0, num_partitions), int32."""
    return _umod(hash_columns(columns), num_partitions)


def bucket_ids(columns, num_buckets: int) -> torch.Tensor:
    """Grouped-execution bucket assignment in [0, num_buckets), int32:
    one extra seeded mix over ``hash_columns``, so bucket ids are
    decorrelated from ``partition_ids`` over the same key."""
    return _umod(mix64(hash_columns(columns) ^ _BUCKET_SEED), num_buckets)

_MASK32 = 0xFFFFFFFF
_M32A = 0x85EBCA6B
_M32B = 0xC2B2AE35
#: second-hash input perturbation for the two-bit Bloom (the unsigned
#: value of the JAX package's int32 ``SKETCH_SEED``)
SKETCH_SEED = 0x9E3779B9


def _low32(keys: torch.Tensor) -> torch.Tensor:
    """int64 holding the unsigned value of ``int32(keys)``."""
    return keys.to(torch.int64) & _MASK32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on unsigned 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _M32A) & _MASK32
    x = x ^ (x >> 13)
    x = (x * _M32B) & _MASK32
    return x ^ (x >> 16)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret unsigned 32-bit values (int64) as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def mix32(keys: torch.Tensor) -> torch.Tensor:
    """int32 murmur3 finalizer of ``int32(keys)``."""
    return _as_int32(_fmix(_low32(keys)))


def mix32_slots(keys: torch.Tensor, nbits: int):
    """The two Bloom bit slots of each key in [0, nbits), int32;
    ``nbits`` must be a power of two."""
    if nbits <= 0 or nbits & (nbits - 1):
        raise ValueError(f"nbits must be a power of two, got {nbits}")
    k = _low32(keys)
    mask = nbits - 1
    return ((_fmix(k) & mask).to(torch.int32),
            (_fmix(k ^ SKETCH_SEED) & mask).to(torch.int32))


def pack_bits(present: torch.Tensor, nwords: int) -> torch.Tensor:
    """[nwords * 32] 0/1 -> [nwords] int32, bit b of word w from
    present[32w + b] (the int64 sum holds the unsigned word; it is
    wrapped to the int32 bit pattern)."""
    bits = present[: nwords * 32].to(torch.int64).view(nwords, 32)
    words = (bits << torch.arange(32, device=present.device)).sum(dim=1)
    return _as_int32(words)


def bloom_build(keys: torch.Tensor, live: torch.Tensor, nbits: int) -> torch.Tensor:
    """[nbits / 32] int32 two-hash Bloom words over the live keys."""
    s1, s2 = mix32_slots(keys, nbits)
    present = torch.zeros(nbits + 1, dtype=torch.int64, device=keys.device)
    trash = torch.full_like(s1, nbits, dtype=torch.int64)
    for s in (s1, s2):
        present.scatter_(0, torch.where(live, s.to(torch.int64), trash),
                         torch.ones_like(trash))
    return pack_bits(present, nbits // 32)


def bloom_test(words: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """bool [n]: Bloom membership (false positives possible, never false
    negatives). ``words`` from ``bloom_build``."""
    nbits = words.shape[0] * 32
    s1, s2 = mix32_slots(keys, nbits)
    w = words.to(torch.int64)

    def bit(s):
        s = s.to(torch.int64)
        return ((w[s >> 5] >> (s & 31)) & 1) != 0

    return bit(s1) & bit(s2)
