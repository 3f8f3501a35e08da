"""Counter-based deterministic CRC outcomes and the ARQ host reference
(port of ``repro.phy.retx``).

Every packet's per-attempt CRC outcome is drawn from a counter-based
hash — no RNG state in the step's carry, no ordering between concurrent
transmissions:

    fail(seed, pkt, attempt)  <=>  h16(seed, pkt, attempt) < perq[link]

where ``h16`` is the low 16 bits of a murmur3-finalizer mix over the
packet's unique id and the attempt counter, and ``perq`` is the link's
packet error rate quantized onto ``[0, 2^16)`` (``phy.rates``).  The draw
does not depend on the link, so CRC outcomes are monotone in link quality.

``crc_hash``/``crc_fail`` take numpy arrays (uint32 arithmetic with
wraparound, as the reference) or torch tensors.  Torch has no uint32
shift, so on tensors the hash runs in int64 and is masked to 32 bits after
every multiply and xor: an int64 product of two 32-bit values wraps
modulo 2^64, which keeps its low 32 bits, and a masked value is
non-negative, so ``>>`` is a logical shift.  ``reference_attempts`` is the
host-side executable spec: the exact attempt count and drop outcome per
packet.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _is_tensor(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _i64(x, dev) -> torch.Tensor:
    """An integer operand as int64 holding its uint32 value."""
    return torch.as_tensor(x, device=dev).to(torch.int64) & M32


def _hash_torch(seed, uid, attempt) -> torch.Tensor:
    dev = next(x.device for x in (seed, uid, attempt)
               if isinstance(x, torch.Tensor))
    uid, attempt, seed = (_i64(x, dev) for x in (uid, attempt, seed))
    x = ((uid * _C1) & M32) ^ seed ^ ((attempt * _C2) & M32)
    x = x ^ (x >> 16)
    x = (x * _C2) & M32
    x = x ^ (x >> 13)
    x = (x * _C3) & M32
    return x ^ (x >> 16)


def _hash_numpy(seed, uid, attempt) -> np.ndarray:
    uid, attempt, seed = (np.asarray(x).astype(np.uint32)
                          for x in (uid, attempt, seed))
    u32 = np.uint32
    with np.errstate(over="ignore"):          # uint32 wraparound is the point
        x = uid * u32(_C1) ^ seed ^ (attempt * u32(_C2))
        x = x ^ (x >> u32(16))
        x = x * u32(_C2)
        x = x ^ (x >> u32(13))
        x = x * u32(_C3)
        x = x ^ (x >> u32(16))
    return x


def crc_hash(seed, uid, attempt):
    """Murmur3-finalizer mix of (seed, packet uid, attempt).

    numpy inputs (any integer dtype) give uint32; when any input is a
    torch tensor the result is an int64 tensor holding the same uint32
    value.
    """
    if _is_tensor(seed, uid, attempt):
        return _hash_torch(seed, uid, attempt)
    return _hash_numpy(seed, uid, attempt)


def crc_fail(seed, uid, attempt, perq):
    """Bool: does attempt ``attempt`` of packet ``uid`` fail CRC?

    ``perq`` is the link's quantized PER threshold (int, ``[0, 2^16)``);
    the low 16 bits of the hash are compared with it as int32, as in the
    reference.
    """
    h = crc_hash(seed, uid, attempt)
    if isinstance(h, torch.Tensor):
        return (h & 0xFFFF).to(torch.int32) < perq
    return (h & np.uint32(0xFFFF)).astype("int32") < perq


def reference_attempts(seed: int, uid, perq, max_retx: int):
    """Host reference: (attempts, delivered) per packet.

    Walks attempts ``0 .. max_retx - 1`` as the engines do: the packet
    delivers on its first CRC pass; after ``max_retx`` failures it is
    dropped.  Returns the number of attempts transmitted and a delivered
    flag, numpy arrays broadcast over ``uid``/``perq``.
    """
    uid = np.asarray(uid, np.int64)
    perq = np.asarray(perq, np.int64)
    uid, perq = np.broadcast_arrays(uid, perq)
    attempts = np.zeros(uid.shape, np.int64)
    delivered = np.zeros(uid.shape, bool)
    pending = np.ones(uid.shape, bool)
    for a in range(max_retx):
        fail = np.asarray(crc_fail(seed, uid, np.full(uid.shape, a),
                                   perq.astype(np.int32)))
        attempts[pending] += 1
        delivered |= pending & ~fail
        pending &= fail
    return attempts, delivered
