"""Counter-based random numbers: threefry2x32 (20 rounds) under each
lane's key, one block per counter value, two float32 uniforms a block.

Words are uint32 arrays (they wrap on overflow); a lane's counter is
one uint64 (the low and high words of the 64-bit block counter).
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = U32(0x1BD11BDA)
#: uniforms are clamped to [U_MIN, 1) so -log(u) stays finite
U_MIN = np.float32(1e-12)


def _rotl(x, r: int):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """One threefry2x32 block of counter (c0, c1) under key (k0, k1):
    uint32 arrays of one broadcastable shape in, two uint32 arrays out."""
    k0, k1, c0, c1 = (np.asarray(v, U32) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for block in range(5):
        for r in ROTATIONS[:4] if block % 2 == 0 else ROTATIONS[4:]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + U32(block + 1)
    return x0, x1


def uniform(bits):
    """Random words -> float32 on [U_MIN, 1): the top 23 bits become the
    mantissa of a float in [1, 2), shifted down by 1."""
    f = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32)
    return np.maximum(f - np.float32(1.0), U_MIN)


def lane_keys(seed: int, lanes) -> np.ndarray:
    """(len(lanes), 2) uint32 keys of the given lane indices of an
    ensemble seeded `seed`: block (0, lane) under the key made of the
    seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    lanes = np.asarray(lanes, np.uint64)
    k0 = np.full(lanes.shape, seed >> 32, U32)
    k1 = np.full(lanes.shape, seed & 0xFFFFFFFF, U32)
    b0, b1 = threefry2x32(k0, k1, np.zeros(lanes.shape, U32),
                          lanes.astype(U32))
    return np.stack([b0, b1], axis=1)


def uniforms(key, ctr):
    """(u1, u2): the two uniforms of counter block `ctr` (uint64) of the
    lanes keyed `key` (..., 2); key and ctr broadcast."""
    ctr = np.asarray(ctr, np.uint64)
    lo = (ctr & np.uint64(0xFFFFFFFF)).astype(U32)
    hi = (ctr >> np.uint64(32)).astype(U32)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], lo, hi)
    return uniform(b0), uniform(b1)
