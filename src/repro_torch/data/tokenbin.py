"""Binary token-file dataset: flat little-endian token stream + json header.

Format (``.tokbin`` + ``.tokbin.json``): the header records dtype
(uint16/uint32), token count, and vocab size; the body is the raw token
array.  Readers are sharded per data-parallel rank by strided sequence
assignment, and addressing is (epoch, offset)-based so the
``fault.RunPosition`` checkpoint metadata resumes the stream sample-exactly.

The port's own copy of ``repro/data/tokenbin.py``, numpy only: a file
written by either package reads the same in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def write_tokenbin(path: str, tokens: np.ndarray, vocab_size: int) -> None:
    dtype = np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.uint32
    arr = np.ascontiguousarray(tokens.astype(dtype))
    with open(path, "wb") as f:
        f.write(arr.tobytes())
    with open(path + ".json", "w") as f:
        json.dump({"dtype": str(np.dtype(dtype)), "num_tokens": int(arr.size),
                   "vocab_size": int(vocab_size)}, f)


@dataclasses.dataclass
class TokenBinDataset:
    path: str
    seq_len: int
    batch_size: int       # per-rank batch
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        with open(self.path + ".json") as f:
            self.header = json.load(f)
        self._data = np.memmap(self.path, dtype=np.dtype(self.header["dtype"]),
                               mode="r")
        self.num_sequences = (self.header["num_tokens"] - 1) // self.seq_len
        assert self.num_sequences >= self.batch_size * self.world, (
            f"{self.path}: {self.num_sequences} sequences < "
            f"batch {self.batch_size} x world {self.world}")

    @property
    def batches_per_epoch(self) -> int:
        return self.num_sequences // (self.batch_size * self.world)

    def _sequence(self, idx: int) -> np.ndarray:
        start = idx * self.seq_len
        return np.asarray(self._data[start: start + self.seq_len + 1], np.int32)

    def batch_at(self, epoch: int, offset: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (epoch, offset); per-epoch shuffle."""
        rng = np.random.default_rng(np.random.SeedSequence([epoch, 7]))
        perm = rng.permutation(self.num_sequences)
        base = offset * self.batch_size * self.world + self.rank * self.batch_size
        idxs = perm[base: base + self.batch_size]
        seqs = np.stack([self._sequence(i) for i in idxs])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def iter_from(self, epoch: int = 0, offset: int = 0
                  ) -> Iterator[Tuple[int, int, Dict[str, np.ndarray]]]:
        while True:
            while offset < self.batches_per_epoch:
                yield epoch, offset, self.batch_at(epoch, offset)
                offset += 1
            epoch += 1
            offset = 0
