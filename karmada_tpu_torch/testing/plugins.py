"""Seeded out-of-tree plugins for tests and the chip smoke.

Both are vectorised numpy over a round's [B, C] grid and read nothing but
the bindings' and clusters' names, so one instance serves the port's
registry and the JAX package's alike (a registry reads only `name` and the
`mask` / `score` method):

- `HashBan`, a FilterPlugin that bans a hashed 1/`share` of the (binding,
  cluster) pairs;
- `HashScore`, a ScorePlugin whose int32 scores span the whole int32
  range, so the in-tree locality score wraps when added and the candidate
  select's radix passes all run.

The hash is crc32 of each name, mixed per pair with a multiply-xorshift in
uint32: the same names give the same terms in every process.
"""
from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

from ..sched.plugins import FilterPlugin, ScorePlugin


def _crc(strings) -> np.ndarray:
    return np.fromiter((zlib.crc32(s.encode()) for s in strings), np.uint32)


def pair_hash(bindings: Sequence, cluster_names: Sequence[str], seed: int) -> np.ndarray:
    """uint32 [len(bindings), len(cluster_names)]: a mix of the binding's
    and the cluster's name hashes and `seed`."""
    hb = _crc(rb.metadata.name for rb in bindings) ^ np.uint32(seed)
    hc = _crc(cluster_names) * np.uint32(0x9E3779B1)
    with np.errstate(over="ignore"):
        x = hb[:, None] ^ hc[None, :]
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


class HashBan(FilterPlugin):
    """Bans the pairs whose hash is 0 modulo `share` (1/`share` of them)."""

    def __init__(self, name: str = "HashBan", share: int = 16, seed: int = 1):
        self.name = name
        self.share = share
        self.seed = seed

    def mask(self, bindings, cluster_names) -> np.ndarray:
        return pair_hash(bindings, cluster_names, self.seed) % np.uint32(self.share) != 0


class HashScore(ScorePlugin):
    """Scores each pair with its hash read as an int32 (the whole range)."""

    def __init__(self, name: str = "HashScore", seed: int = 2):
        self.name = name
        self.seed = seed

    def score(self, bindings, cluster_names) -> np.ndarray:
        return pair_hash(bindings, cluster_names, self.seed).view(np.int32)


def hash_registry(registry_cls, share: int = 16):
    """A `registry_cls()` (either package's PluginRegistry) holding one
    HashBan and one HashScore."""
    reg = registry_cls()
    reg.register(HashBan(share=share))
    reg.register(HashScore())
    return reg
