"""Corpus and traffic from a seed, by the distributions a configuration
and a traffic mix name (``perfbench/dists/<dist>.py``).

A corpus is integer term ids (a flat int32 array and int64 offsets):
the reference reads them as they are, and the program gets them as
token lists, one interned string ``t<id>`` per term, as the upstream
scale test names its terms."""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass

import numpy as np

from perfbench import plugins

_BLOCK = 1 << 23   # tokens drawn at a time


def dist(params: dict):
    """A sampler ``draw(rng, size)`` for {"dist": <name>, ...}; built once
    a process for each distinct ``params`` (the Zipf table takes ~1 s)."""
    return _sampler(json.dumps(params, sort_keys=True))


@functools.lru_cache(maxsize=16)
def _sampler(key: str):
    params = json.loads(key)
    return plugins.load_module("dists", params["dist"]).sampler(params)


def streams(seed: int, n: int = 3) -> list:
    """Independent generators for corpus, traffic and the check's
    sample, from any whole-number seed (negative or past 64 bits too)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


@dataclass
class Texts:
    """Token-id sequences: sequence i is ids[offsets[i]:offsets[i+1]]."""
    ids: np.ndarray       # int32
    offsets: np.ndarray   # int64, len n + 1

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row(self, i: int) -> np.ndarray:
        return self.ids[self.offsets[i]:self.offsets[i + 1]]


def draw_texts(rng, n: int, length: dict, terms: dict) -> Texts:
    lengths = dist(length)(rng, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    draw = dist(terms)
    ids = np.empty(total, dtype=np.int32)
    for lo in range(0, total, _BLOCK):
        hi = min(lo + _BLOCK, total)
        ids[lo:hi] = draw(rng, hi - lo)
    return Texts(ids, offsets)


def corpus(config: dict, rng) -> Texts:
    c = config["corpus"]
    return draw_texts(rng, int(c["docs"]), c["length"], c["terms"])


def queries(config: dict, rng, n: int) -> Texts:
    q = config["queries"]
    return draw_texts(rng, n, q["length"], q["terms"])


def request_sizes(traffic: dict, rng) -> np.ndarray:
    return dist(traffic["batch"])(rng, int(traffic["pool"]))


def token_names(vocab: int) -> np.ndarray:
    return np.array([f"t{i}" for i in range(vocab)], dtype=object)


def to_tokens(texts: Texts, names: np.ndarray) -> list:
    """Token lists for the program, in blocks of ~8M tokens."""
    out: list = []
    lens = texts.lengths()
    n = len(texts)
    if n and (lens == lens[0]).all():
        # One length: a 2D take and tolist give the lists in C.
        width = int(lens[0])
        rows = max(1, _BLOCK // max(width, 1))
        grid = texts.ids.reshape(n, width)
        for lo in range(0, n, rows):
            out.extend(names[grid[lo:lo + rows]].tolist())
        return out
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(texts.offsets,
                                 texts.offsets[lo] + _BLOCK, "right"))
        hi = min(max(hi - 1, lo + 1), n)
        base = texts.offsets[lo]
        flat = names[texts.ids[base:texts.offsets[hi]]].tolist()
        offs = (texts.offsets[lo:hi + 1] - base).tolist()
        out.extend(flat[offs[i]:offs[i + 1]] for i in range(hi - lo))
        lo = hi
    return out


@dataclass
class Pool:
    """The cell's distinct requests: request r is queries
    starts[r]:starts[r+1] of ``texts``; ``tokens[r]`` is its token
    lists as the entry takes them (after ``tokenize``)."""
    texts: Texts
    starts: np.ndarray
    tokens: list | None = None

    def __len__(self) -> int:
        return len(self.starts) - 1

    def size(self, r: int) -> int:
        return int(self.starts[r + 1] - self.starts[r])

    def tokenize(self, names: np.ndarray) -> None:
        flat = to_tokens(self.texts, names)
        self.tokens = [flat[self.starts[r]:self.starts[r + 1]]
                       for r in range(len(self))]


def pool(config: dict, traffic: dict, rng) -> Pool:
    sizes = request_sizes(traffic, rng)
    starts = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    return Pool(queries(config, rng, int(starts[-1])), starts)
