"""vitcap_tpu_torch's `loader: grain` (data/grain_loader.py, no Grain)
against the JAX package's GrainDataLoader (which drives Grain) on the
CPU: identical batches, in the same order, in test mode, over 2 shards,
shuffled over several epochs, resumed at start_iter, and with worker
processes; its index_shuffle against Grain's compiled one.
"""

import pickle

import numpy as np
import pytest

from grain._src.python.experimental.index_shuffle.python import (
    index_shuffle_module as grain_shuffle)
from vitcap_tpu.data.grain_loader import GrainDataLoader as JaxLoader

from vitcap_tpu_torch.data import grain_loader as TG


class ToyDataset:
    """dataset[i] -> a sample dict with an array, a string and a list."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.asarray([i, 2 * i], np.int64), "key": f"k{i}",
                "img": np.full((2, 3), i, np.float32)}


def _batches(loader):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else list(v))
             for k, v in b.items()} for b in loader]


CASES = {
    "test": dict(n=10, bs=4),
    "test_uneven": dict(n=7, bs=3),
    "test_2_shards_0": dict(n=11, bs=2, shard_index=0, shard_count=2),
    "test_2_shards_1": dict(n=11, bs=2, shard_index=1, shard_count=2),
    "train_epochs": dict(n=8, bs=4, shuffle=True, seed=3, infinite=True,
                         max_iter=9),
    "train_unshuffled": dict(n=9, bs=4, infinite=True, max_iter=5),
    "train_2_shards_1": dict(n=17, bs=3, shuffle=True, seed=5,
                             infinite=True, max_iter=8, shard_index=1,
                             shard_count=2),
    "resume": dict(n=16, bs=4, shuffle=True, seed=7, infinite=True,
                   max_iter=10, start_iter=6),
    "resume_2_shards": dict(n=20, bs=2, shuffle=True, seed=11,
                            infinite=True, max_iter=12, start_iter=5,
                            shard_index=1, shard_count=2),
    "large_seed": dict(n=300, bs=32, shuffle=True, seed=2 ** 32 - 1,
                       infinite=True, max_iter=20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_match_jax_grain_loader(case):
    kw = dict(CASES[case])
    n, bs = kw.pop("n"), kw.pop("bs")
    want = _batches(JaxLoader(ToyDataset(n), bs, **kw))
    port = TG.GrainDataLoader(ToyDataset(n), bs, **kw)
    got = _batches(port)
    assert got == want
    assert len(port) == len(JaxLoader(ToyDataset(n), bs, **kw))
    if kw.get("infinite"):
        assert len(got) == kw["max_iter"] - kw.get("start_iter", 0)


def test_resume_continues_the_run():
    kw = dict(shuffle=True, seed=7, infinite=True, max_iter=10)
    full = _batches(TG.GrainDataLoader(ToyDataset(16), 4, **kw))
    resumed = _batches(TG.GrainDataLoader(ToyDataset(16), 4, start_iter=6,
                                          **kw))
    assert resumed == full[6:]


def test_epochs_cover_the_shard_and_reshuffle():
    got = [b["x"][:, 0].tolist() for b in TG.GrainDataLoader(
        ToyDataset(8), 4, shuffle=True, seed=3, infinite=True, max_iter=6)]
    for e in range(3):
        assert sorted(got[2 * e] + got[2 * e + 1]) == list(range(8))
    assert got[:2] != got[2:4]


def test_workers_give_the_same_batches():
    """grain_workers 2 (spawned processes): the same batches as 0 and as
    the JAX loader with 2 Grain workers."""
    kw = dict(shuffle=True, seed=4, infinite=True, max_iter=5)
    in_process = _batches(TG.GrainDataLoader(ToyDataset(12), 4, **kw))
    workers = _batches(TG.GrainDataLoader(ToyDataset(12), 4, num_workers=2,
                                          **kw))
    assert workers == in_process
    assert workers == _batches(JaxLoader(ToyDataset(12), 4, num_workers=2,
                                         **kw))


def test_exhausted_infinite_stream_raises():
    loader = TG.GrainDataLoader(ToyDataset(8), 4, shuffle=True, seed=1,
                                infinite=True, max_iter=4)
    loader._records = 10             # a stream that ends before max_iter
    with pytest.raises(RuntimeError, match="exhausted after 2 of 4"):
        list(loader)


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="never emit a batch"):
        TG.GrainDataLoader(ToyDataset(3), 4, infinite=True, max_iter=2)
    with pytest.raises(ValueError):
        TG.GrainDataLoader(ToyDataset(0), 4)
    with pytest.raises(ValueError, match="32-bit"):
        TG.GrainDataLoader(ToyDataset(5), 2, shuffle=True, seed=2 ** 32)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 255, 256, 257, 65536, 65537,
                               100003, 1500007])
def test_index_shuffle_matches_grain(n):
    """Small blocks walk a table of the whole block, past 2**20 each index
    walks on its own: both against Grain's compiled index_shuffle."""
    idx = np.unique(np.concatenate([np.arange(min(n, 500)),
                                    np.random.RandomState(n).randint(
                                        0, n, 200)]))
    for seed in (0, 9, 2 ** 31 + 7):
        want = [grain_shuffle.index_shuffle(int(i), max_index=n - 1,
                                            seed=seed, rounds=4)
                for i in idx]
        assert TG.index_shuffle(idx, n - 1, seed).tolist() == want
    perm = TG.index_shuffle(np.arange(n), n - 1, 5)
    if n != 65537:                  # a permutation
        assert sorted(perm.tolist()) == list(range(n))
    else:
        # Grain sizes the block by log2(max_index): at max_index = 2**16
        # the 16-bit block cannot hold max_index, and the shuffle repeats
        # records; the port repeats the same ones
        assert len(set(perm.tolist())) < n


def test_sampler_pickles_and_even_split_matches_grain():
    from grain._src.core import sharding
    for n in (7, 10, 11):
        for count in (1, 2, 3):
            for drop in (False, True):
                for index in range(count):
                    opts = sharding.ShardOptions(index, count, drop)
                    assert TG.even_split(n, index, count, drop) == \
                        sharding.even_split(n, opts)
    s = TG.IndexSampler(10, shuffle=True, num_epochs=2, seed=3)
    keys = [s.record_key(i) for i in range(20)]
    t = pickle.loads(pickle.dumps(s))
    assert [t.record_key(i) for i in range(20)] == keys
    with pytest.raises(IndexError):
        s.record_key(20)
