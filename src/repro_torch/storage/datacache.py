"""Training-data shard cache: the paper's two-tier store feeding the
trainer.

Shards (fixed-size token files on disk) are tier 2; tier 1 caches them in
host RAM. Eviction is the §III-A online-learning weight-sharing policy
(a host mirror of LRU / LFU / Random experts whose weights decay with
their mispredictions), and a stream identifier on the miss stream
prefetches the next shards into free slots.

Host numpy, carried over from the reference (``repro.storage.datacache``)
as a copy: the same seed gives the same shards, hits, misses, victims and
batches, byte for byte. ``DataCache.batch`` returns numpy; the training
launcher moves each batch to the card through pinned memory.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict

import numpy as np

__all__ = ["DataCacheConfig", "ShardedTokenStore", "DataCache"]


@dataclasses.dataclass(frozen=True)
class DataCacheConfig:
    cache_shards: int = 8        # tier-1 capacity (shards in RAM)
    policy: str = "ws"           # ws | lru | lfu
    epoch_width: int = 4
    beta: float = 0.7
    alpha: float = 0.5
    threshold: float = 0.25
    prefetch_depth: int = 2


class ShardedTokenStore:
    """Tier 2: token shards on disk (synthetic corpus generator included)."""

    def __init__(self, root: str, n_shards: int, shard_tokens: int,
                 vocab: int, seed: int = 0):
        self.root = root
        self.n_shards = n_shards
        self.shard_tokens = shard_tokens
        self.vocab = vocab
        os.makedirs(root, exist_ok=True)
        rng = np.random.default_rng(seed)
        for s in range(n_shards):
            fn = self._path(s)
            if not os.path.exists(fn):
                toks = rng.integers(0, vocab, shard_tokens, dtype=np.int32)
                np.save(fn, toks)

    def _path(self, s: int) -> str:
        return os.path.join(self.root, f"shard_{s:05d}.npy")

    def read(self, s: int) -> np.ndarray:
        return np.load(self._path(s))


class _HostOL:
    """Host-side mirror of the OL weight-sharing policy (numpy, §III-A)."""

    def __init__(self, cfg: DataCacheConfig):
        self.cfg = cfg
        self.weights = np.ones(3) / 3
        self.pred: list[set] = [set(), set(), set()]
        self.mispred = np.zeros(3, int)
        self.epoch_misses = 0
        self.t = 0
        self.rng = np.random.default_rng(0)

    def choose(self) -> int:
        if self.cfg.policy != "ws":
            return {"lru": 0, "lfu": 1}.get(self.cfg.policy, 0)
        return int(np.argmax(self.weights))

    def note_miss(self, shard: int):
        self.epoch_misses += 1
        for i in range(3):
            if shard in self.pred[i]:
                self.mispred[i] += 1

    def record(self, proposals):
        for i, p in enumerate(proposals):
            self.pred[i].add(p)

    def tick(self):
        self.t += 1
        if self.t % self.cfg.epoch_width:
            return
        thr = self.cfg.threshold * self.epoch_misses
        losses = np.where(self.mispred >= thr, self.mispred, 0)
        prev = self.weights.copy()
        self.weights = self.weights * (self.cfg.beta ** losses)
        self.weights += self.cfg.alpha * np.mean(prev - self.weights)
        self.weights = np.maximum(self.weights, 1e-8)
        self.weights /= self.weights.sum()
        self.pred = [set(), set(), set()]
        self.mispred[:] = 0
        self.epoch_misses = 0


class DataCache:
    """Tier-1 shard cache with OL eviction + stride prefetch."""

    def __init__(self, store: ShardedTokenStore, cfg: DataCacheConfig):
        self.store = store
        self.cfg = cfg
        self.cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.freq: dict[int, int] = {}
        self.ts: dict[int, int] = {}
        self.ol = _HostOL(cfg)
        self.hits = 0
        self.misses = 0
        self.last_miss = -1
        self.stride = 0
        self.conf = 0

    def _proposals(self):
        if not self.cache:
            return (None, None, None)
        lru = min(self.cache, key=lambda s: self.ts[s])
        lfu = min(self.cache, key=lambda s: self.freq[s])
        rnd = self.ol.rng.choice(list(self.cache))
        return (lru, lfu, int(rnd))

    def _insert(self, s: int, data: np.ndarray):
        while len(self.cache) >= self.cfg.cache_shards:
            props = self._proposals()
            self.ol.record(props)
            victim = props[self.ol.choose()]
            self.cache.pop(victim, None)
        self.cache[s] = data
        self.freq[s] = self.freq.get(s, 0) + 1
        self.ts[s] = self.ol.t

    def get(self, s: int) -> np.ndarray:
        self.ol.tick()
        if s in self.cache:
            self.hits += 1
            self.freq[s] += 1
            self.ts[s] = self.ol.t
            return self.cache[s]
        self.misses += 1
        self.ol.note_miss(s)
        # Stream identifier on the miss stream.
        delta = s - self.last_miss
        if self.last_miss >= 0 and delta == self.stride and delta != 0:
            self.conf += 1
        elif delta != 0:
            self.stride, self.conf = delta, 1
        self.last_miss = s
        data = self.store.read(s)
        self._insert(s, data)
        # Prefetch (only into free slots, like the paper's prefetch buffer).
        if self.conf >= 2:
            for k in range(1, self.cfg.prefetch_depth + 1):
                nxt = (s + k * self.stride) % self.store.n_shards
                if nxt not in self.cache and \
                        len(self.cache) < self.cfg.cache_shards:
                    self._insert(nxt, self.store.read(nxt))
        return data

    def batch(self, step: int, batch: int, seq: int, *,
              shards_per_step: int = 1) -> dict:
        """Deterministic batch assembly: step -> shard ids -> sequences."""
        toks_needed = batch * (seq + 1)
        shard = (step * shards_per_step) % self.store.n_shards
        data = self.get(shard)
        reps = -(-toks_needed // len(data))
        flat = np.concatenate([data] * reps)[:toks_needed]
        arr = flat.reshape(batch, seq + 1)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}
