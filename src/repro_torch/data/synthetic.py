"""Deterministic synthetic LM data.

Sample-exact resumability: batch ``i`` is a pure function of (seed, i, rank),
so restarts and elastic re-runs reproduce the identical stream without any
state beyond the step counter.  The token distribution is Zipfian with a
small amount of local structure (bigram copy) so losses actually decrease
during the example training runs.

The port's own copy of ``repro/data/synthetic.py``, numpy only, so its
batches equal the reference's byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-process batch
    seed: int = 0
    zipf_a: float = 1.2
    copy_prob: float = 0.3     # p(token_t = token_{t-2}): learnable structure


class SyntheticDataset:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch_at(self, index: int, rank: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, rank, index]))
        shape = (cfg.batch_size, cfg.seq_len + 1)
        toks = rng.choice(cfg.vocab_size, size=shape, p=self._probs)
        if cfg.copy_prob > 0:
            copy = rng.random(shape) < cfg.copy_prob
            copy[:, :2] = False
            shifted = np.roll(toks, 2, axis=1)
            toks = np.where(copy, shifted, toks)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def batch_for_model(cfg: ModelConfig, data: Dict[str, np.ndarray],
                    rng: Optional[np.random.Generator] = None) -> Dict:
    """Attach modality-stub inputs (vision/audio) required by the config."""
    rng = rng or np.random.default_rng(0)
    out = dict(data)
    B = data["tokens"].shape[0]
    if cfg.num_vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model), dtype=np.float32) * 0.1
    if cfg.is_encdec:
        T = max(data["tokens"].shape[1] // 2, 1)
        out["enc_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model), dtype=np.float32) * 0.1
    return out
