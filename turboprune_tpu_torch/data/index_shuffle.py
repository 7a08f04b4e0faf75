"""grain's global shuffle, in numpy, a whole pass at a time.

The JAX package's ImageNet loader shuffles with grain's
``MapDataset.shuffle`` (through ``IndexSampler``): stream position ``i``
of a dataset of ``n`` records reads record
``index_shuffle(i % n, max_index=n - 1, seed=(seed + i // n) % 2**32,
rounds=4) + (i // n) * n``. grain's ``index_shuffle`` is compiled C++, a
copy of TensorFlow's ``random_index_shuffle``: a cycle-walk over a Simon
block cipher. This module is that function, held bit for bit against
grain's compiled module by ``tests/test_torch_imagenet.py``:

- the block width ``W`` is ``ceil(log2(max_index))`` (of ``max_index``,
  not ``max_index + 1``), made even, and at least 16; the cipher works on
  two ``W/2``-bit halves (an input wider than ``W`` bits loses its high
  bits, as ``std::bitset`` truncates);
- the round keys are ``rounds`` 32-bit words from ``std::seed_seq{seed}``
  (``seed_seq_generate``), each truncated to ``W/2`` bits;
- each pair of keys is two Simon rounds with ``f(x) = (rotl(x, 1) &
  rotl(x, 8)) ^ rotl(x, 2)``: ``left ^= f(right) ^ k0``, then ``right ^=
  f(left) ^ k1``; the output is ``left << W/2 | right``;
- the cipher is applied again until the value is at most ``max_index``.

A permutation of a pass of 1.28 M records takes a few numpy passes over
the array, not a Python loop per record. Where the block is much wider
than the range (small ``max_index``: the block is at least 16 bits), a
cycle walk would take thousands of steps; there the cipher is tabulated
over the whole block once and the walk is resolved by pointer doubling.
"""

from __future__ import annotations

import numpy as np

MIN_BLOCK_SIZE = 16
_M32 = 0xFFFFFFFF


def seed_seq_generate(seed: int, n: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    if n == 0:
        return []
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def tmix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * tmix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * tmix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def block_size(max_index: int) -> int:
    """The cipher's block width for ``max_index`` (grain's rule)."""
    w = int(np.ceil(np.log2(float(max_index))))
    w += w % 2
    return max(w, MIN_BLOCK_SIZE)


def _encrypt(x: np.ndarray, keys: list[int], half: int) -> np.ndarray:
    mask = np.uint64((1 << half) - 1)
    h = np.uint64(half)

    def rotl(v: np.ndarray, r: int) -> np.ndarray:
        return ((v << np.uint64(r)) | (v >> np.uint64(half - r))) & mask

    def f(v: np.ndarray) -> np.ndarray:
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    left = (x >> h) & mask
    right = x & mask
    for i in range(0, len(keys), 2):
        left = left ^ f(right) ^ np.uint64(keys[i] & int(mask))
        right = right ^ f(left) ^ np.uint64(keys[i + 1] & int(mask))
    return (left << h) | right


def _walk_table(keys: list[int], half: int, max_index: int) -> np.ndarray:
    """The cycle walk's result for every value of the block: the cipher
    applied to all ``2**(2*half)`` values, then pointer doubling (a value
    whose pointer is out of range takes its pointer's pointer) until every
    start the walk can take (``[0, max_index]``, truncated to the block)
    lands in range."""
    size = 1 << (2 * half)
    jump = _encrypt(np.arange(size, dtype=np.uint64), keys, half)
    top = np.uint64(max_index)
    starts = slice(0, min(max_index + 1, size))
    while (jump[starts] > top).any():
        jump = np.where(jump > top, jump[jump], jump)
    return jump


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """grain's ``index_shuffle`` of each of ``index`` (an int or an array;
    each in ``[0, max_index]``) under ``seed`` (32 bits); returns uint64."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and >= 4, got {rounds}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be a 32-bit unsigned integer, got {seed}")
    x = np.asarray(index, dtype=np.uint64)
    if max_index == 0:
        return np.zeros_like(x)
    keys = seed_seq_generate(seed, rounds)
    width = block_size(max_index)
    half = width // 2
    top = np.uint64(max_index)
    if (1 << width) > 8 * (max_index + 1):
        return _walk_table(keys, half, max_index)[x & np.uint64((1 << width) - 1)]
    out = _encrypt(x.ravel(), keys, half)
    todo = np.flatnonzero(out > top)
    while todo.size:  # the cycle walk: re-encrypt what fell outside
        out[todo] = _encrypt(out[todo], keys, half)
        todo = todo[out[todo] > top]
    return out.reshape(x.shape)


def shuffled_positions(positions: np.ndarray, n: int, seed: int) -> np.ndarray:
    """The record keys at stream ``positions`` of grain's
    ``MapDataset.shuffle(seed)`` over ``n`` records: pass ``i // n`` is
    permuted with seed ``(seed + pass) % 2**32``. int64."""
    positions = np.asarray(positions, dtype=np.int64)
    out = np.empty_like(positions)
    passes = positions // n
    for e in np.unique(passes):
        sel = passes == e
        within = positions[sel] - e * n
        out[sel] = index_shuffle(within, n - 1, int((seed + e) % 2**32)).astype(np.int64) + e * n
    return out
