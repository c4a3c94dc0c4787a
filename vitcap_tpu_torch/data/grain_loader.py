"""`loader: grain` without Grain: the port's copy of
vitcap_tpu/data/grain_loader.py, yielding the same batches in the same
order.

The JAX package drives Google Grain (grain.python.DataLoader over an
IndexSampler).  Grain is a JAX-ecosystem package (importing grain.python
imports jax), so the port reproduces what that loader yields instead of
calling it: IndexSampler's record order (even sharding, epochs, a per-epoch
Feistel shuffle of each shard), the JAX wrapper's O(1) resume (its
_OffsetSampler view shifted by start_iter batches) and its batching in the
parent.  `num_workers` > 0 fetches records in that many worker processes
(torch.utils.data workers over the record order, started with spawn):
records come back in sampler order, so the batches do not depend on the
number of workers.

Select with `loader: grain` in the pipeline YAML (`grain_workers` worker
processes; 0 = in-process).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .dataset import collate_numpy

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Grain's index_shuffle
# ---------------------------------------------------------------------------
# A numpy rendering of the permutation that grain.python's ShuffleMapDataset
# draws through its compiled index_shuffle (Grain,
# grain/_src/python/experimental/index_shuffle, Apache License 2.0, itself
# after TensorFlow's random_index_shuffle): a Simon-cipher Feistel network
# on a block of 2W bits (the even bit length of max_index, at least 16),
# round keys from std::seed_seq{seed}, and cycle walking back into
# [0, max_index].  Grain's pure-Python index_shuffle module draws another
# permutation and is not the one its samplers use.

def _seed_seq(seed: int, n: int) -> List[int]:
    """std::seed_seq{seed}.generate() of n 32-bit words (the C++
    standard's [rand.util.seedseq] algorithm)."""
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else
         3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)
    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) \
            & _M32
        r2 = (r1 + (s if k == 0 else (k % n + v[k - 1]) if k <= s
                    else k % n)) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n]
                                + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4
                  ) -> np.ndarray:
    """The position of each `index` (an int or an array, in
    [0, max_index]) in Grain's pseudorandom permutation of
    [0, max_index] under `seed` (32 bits) with `rounds` (even, >= 4)
    Simon rounds."""
    index = np.asarray(index, np.uint64)
    if max_index == 0:
        return np.zeros_like(index)
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and >= 4, got {rounds}")
    block = int(math.ceil(math.log2(float(max_index))))
    block = max(block + block % 2, 16)
    if block > 64:
        raise ValueError(f"max_index {max_index} past 64 bits")
    w = block // 2
    mask = np.uint64((1 << w) - 1)
    keys = [np.uint64(k & ((1 << w) - 1)) for k in _seed_seq(seed, rounds)]
    sh = {r: (np.uint64(r % w), np.uint64(w - r % w)) for r in (1, 2, 8)}

    def rotl(x, r):
        a, b = sh[r]
        return ((x << a) | (x >> b)) & mask

    def f(x):
        return (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)

    def encrypt(v):
        left, right = (v >> np.uint64(w)) & mask, v & mask
        for i in range(0, rounds, 2):
            left = left ^ f(right) ^ keys[i]
            right = right ^ f(left) ^ keys[i + 1]
        return (left << np.uint64(w)) | right

    if block <= 20:
        # a small block (max_index < 2**20): encrypt the whole block once
        # and walk in the table.  walk[v] is v within [0, max_index], and
        # the next encryption past it; squaring it `block` times follows
        # every walk to its end (no walk is longer than the block)
        table = encrypt(np.arange(1 << block, dtype=np.uint64))
        walk = np.where(np.arange(1 << block) > max_index, table,
                        np.arange(1 << block, dtype=np.uint64))
        for _ in range(block):
            walk = walk[walk]
        # (the cipher reads an index's low `block` bits: at max_index =
        # 2**16, index 2**16 encrypts as 0 does, in Grain too)
        return walk[table[index & np.uint64((1 << block) - 1)]]
    out = index.copy().reshape(-1)
    todo = np.arange(out.size)
    while todo.size:                 # cycle walking: re-encrypt past max
        out[todo] = encrypt(out[todo])
        todo = todo[out[todo] > np.uint64(max_index)]
    return out.reshape(index.shape)


# ---------------------------------------------------------------------------
# grain.python.IndexSampler's record order
# ---------------------------------------------------------------------------

def even_split(n: int, shard_index: int, shard_count: int,
               drop_remainder: bool) -> Tuple[int, int]:
    """[start, end) of a shard (grain's sharding.even_split): equal
    shards, the remainder dropped or spread over the first shards."""
    per = n // shard_count
    start, end = per * shard_index, per * (shard_index + 1)
    rem = n % shard_count
    if rem and not drop_remainder:
        start += min(shard_index, rem)
        end += min(shard_index + 1, rem)
    return start, end


class IndexSampler:
    """The record keys of grain.python.IndexSampler(num_records,
    ShardOptions(shard_index, shard_count, drop_remainder), shuffle,
    num_epochs, seed), by global sampler index: index i reads position
    i // shard_count of the shard's sequence, which repeats the shard
    every epoch, shuffled per epoch with seed (seed + epoch) % 2**32."""

    def __init__(self, num_records: int, shard_index: int = 0,
                 shard_count: int = 1, drop_remainder: bool = False,
                 shuffle: bool = False, num_epochs: Optional[int] = None,
                 seed: Optional[int] = None):
        if num_records <= 0:
            raise ValueError(f"IndexSampler needs records, got "
                             f"{num_records}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive, got "
                             f"{num_epochs}")
        if shuffle and seed is None:
            raise ValueError("shuffling requires a seed")
        if seed is not None and (seed < 0 or int(seed).bit_length() > 32):
            raise ValueError("the seed must be a non-negative 32-bit int")
        self.shard_count = shard_count
        self.shuffle = shuffle
        self.seed = seed
        self.start, end = even_split(num_records, shard_index, shard_count,
                                     drop_remainder)
        self.shard_len = end - self.start
        self._max_index = (None if num_epochs is None
                           else num_epochs * num_records)
        if self._max_index is not None and drop_remainder:
            self._max_index = min(
                self._max_index, self.shard_len * shard_count * num_epochs)
        self._perm: Tuple[int, Optional[np.ndarray]] = (-1, None)

    def __len__(self) -> int:
        return (np.iinfo(np.int64).max if self._max_index is None
                else self._max_index)

    def _permutation(self, epoch: int) -> np.ndarray:
        if self._perm[0] != epoch:
            n = self.shard_len
            self._perm = (epoch, index_shuffle(
                np.arange(n), n - 1, (self.seed + epoch) % 2 ** 32))
        return self._perm[1]

    def record_key(self, index: int) -> int:
        if index < 0 or (self._max_index is not None
                         and index >= self._max_index):
            raise IndexError(f"sampler index {index} outside "
                             f"[0, {self._max_index})")
        epoch, k = divmod(index // self.shard_count, self.shard_len)
        if self.shuffle:
            k = int(self._permutation(epoch)[k])
        return self.start + k


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _identity(x):
    return x


class GrainDataLoader:
    """The JAX package's GrainDataLoader, batch for batch, over a
    map-style dataset (dataset[i] -> sample dict).

    Train (`infinite=True`): sharded + seeded shuffle, re-shuffled each
    epoch, yields exactly `max_iter - start_iter` batches, resumed in O(1)
    at `start_iter`.  Test: one sequential epoch, keep the remainder.
    """

    def __init__(self, dataset, batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 infinite: bool = False, max_iter: Optional[int] = None,
                 start_iter: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 num_workers: int = 0,
                 collate_fn: Callable = collate_numpy,
                 read_buffer: int = 64):
        self.dataset = dataset
        self.batch_size = batch_size
        self.start_iter = start_iter
        self.num_workers = num_workers
        self.read_buffer = read_buffer
        self._infinite = infinite
        self._collate = collate_fn
        n = len(dataset)
        if infinite:
            if max_iter is None:
                raise ValueError("an infinite loader needs max_iter")
            per_shard = n // shard_count if shard_count > 1 else n
            self._len = max_iter - start_iter
            batches_per_epoch = per_shard // batch_size
            if batches_per_epoch == 0:
                raise ValueError(
                    f"shard has {per_shard} records < batch_size "
                    f"{batch_size}: with drop_remainder the loader would "
                    f"never emit a batch")
            epochs = math.ceil(max_iter / batches_per_epoch) + 1
        else:
            per_shard = int(math.ceil(n / shard_count))
            self._len = int(math.ceil(per_shard / batch_size))
            epochs = 1
        self._sampler = IndexSampler(
            n, shard_index, shard_count, drop_remainder=infinite,
            shuffle=shuffle, num_epochs=epochs, seed=seed)
        self._shard_index = shard_index
        # O(1) resume: the sampler is random-access by global index, so a
        # restart views its sequence shifted by start_iter batches (the
        # JAX loader's _OffsetSampler)
        self._offset = start_iter * batch_size
        self._records = (max(0, len(self._sampler) - self._offset)
                         // shard_count)

    def __len__(self) -> int:
        return self._len

    def record_keys(self) -> Iterator[int]:
        """The dataset indices the loader reads, in order."""
        sc = self._sampler.shard_count
        for j in range(self._records):
            yield self._sampler.record_key(
                j * sc + self._shard_index + self._offset)

    def _samples(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers == 0:
            return (self.dataset[k] for k in self.record_keys())
        import torch.utils.data as tud
        return iter(tud.DataLoader(
            self.dataset, batch_size=None, sampler=_Keys(self),
            num_workers=self.num_workers, collate_fn=_identity,
            multiprocessing_context="spawn",
            prefetch_factor=max(2, -(-self.read_buffer
                                     // self.num_workers))))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = self._samples()
        for i in range(self._len):
            buf = []
            try:
                while len(buf) < self.batch_size:
                    buf.append(next(it))
            except StopIteration:
                if self._infinite:
                    raise RuntimeError(      # never silently under-train
                        f"grain pipeline exhausted after {i} of "
                        f"{self._len} batches")
                if not buf:
                    return
            yield self._collate(buf)


class _Keys:
    """The loader's record order as a torch sampler (iterated in the
    parent; the workers get only the indices)."""

    def __init__(self, loader: GrainDataLoader):
        self._loader = loader

    def __iter__(self):
        return self._loader.record_keys()

    def __len__(self) -> int:
        return self._loader._records
