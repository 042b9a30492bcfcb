"""Deterministic synthetic LM data (the WikiText-2 stand-in), numpy only.

The port's own copy of ``repro.data.pipeline``: a hidden-state Markov
source over a Zipf-distributed vocabulary, whose every batch is a pure
function of (seed, step, host).  The port imports nothing of the JAX
package, so it keeps this copy; ``tests/test_torch_train.py`` holds it to
the original batch for batch.

One change of method, not of result: a token is drawn with
``np.searchsorted`` on the state's cumulative emission row instead of
counting the entries below the uniform draw.  The row is non-decreasing, so
the two give the same index; the search costs O(log V) per token instead of
O(V), which at distilgpt2's 50,257-token vocabulary is the difference
between milliseconds and seconds per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_states: int = 64  # hidden Markov states
    zipf_a: float = 1.2
    frontend: str = "none"  # none | patch | frame (mirrors ModelConfig)
    frontend_dim: int = 32
    num_prefix_tokens: int = 4


class SyntheticCorpus:
    """Hidden-Markov token source with Zipfian emission."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, s = cfg.vocab_size, cfg.num_states
        # transition matrix: sparse-ish, row-stochastic
        trans = rng.dirichlet(np.full(s, 0.1), size=s)
        self.trans_cum = np.cumsum(trans, axis=1)
        # per-state emission: a Zipf ranking permuted per state
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = 1.0 / ranks ** cfg.zipf_a
        emissions = np.stack([base[rng.permutation(v)] for _ in range(s)], axis=0)
        emissions /= emissions.sum(axis=1, keepdims=True)
        self.emit_cum = np.cumsum(emissions, axis=1)

    def sample(self, rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
        s = rng.integers(0, self.cfg.num_states, size=batch)
        out = np.empty((batch, length), np.int32)
        for t in range(length):
            u = rng.random(batch)
            for b in range(batch):  # = (emit_cum[s[b]] < u[b]).sum()
                out[b, t] = np.searchsorted(self.emit_cum[s[b]], u[b], side="left")
            u2 = rng.random(batch)
            s = (self.trans_cum[s] < u2[:, None]).sum(axis=1)
        np.clip(out, 0, self.cfg.vocab_size - 1, out=out)
        return out


class ShardedLoader:
    """Deterministic per-host batch iterator with O(1) seek (resume)."""

    def __init__(self, cfg: DataConfig, *, host_index: int = 0, num_hosts: int = 1, start_step: int = 0):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.step = start_step
        self.corpus = SyntheticCorpus(cfg)

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, step, self.host_index))

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(self.step)
        local = cfg.global_batch // self.num_hosts
        batch: Dict[str, np.ndarray] = {}
        if cfg.frontend == "frame":
            tokens = self.corpus.sample(rng, local, cfg.seq_len)
            batch["frame_embeds"] = rng.standard_normal(
                (local, cfg.seq_len, cfg.frontend_dim), dtype=np.float32
            )
            batch["labels"] = tokens
        elif cfg.frontend == "patch":
            p = cfg.num_prefix_tokens
            tokens = self.corpus.sample(rng, local, cfg.seq_len - p)
            batch["tokens"] = tokens
            batch["patch_embeds"] = rng.standard_normal((local, p, cfg.frontend_dim), dtype=np.float32)
            labels = np.full((local, cfg.seq_len), -100, np.int32)
            labels[:, p:] = tokens
            batch["labels"] = labels
        else:
            tokens = self.corpus.sample(rng, local, cfg.seq_len + 1)
            batch["tokens"] = tokens[:, :-1]
            batch["labels"] = tokens[:, 1:]
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def loader_for_model(model_cfg, *, seq_len: int, global_batch: int, seed: int = 0,
                     host_index: int = 0, num_hosts: int = 1, start_step: int = 0):
    """Build a loader matching a ModelConfig's frontend contract."""
    cfg = DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        frontend=model_cfg.frontend,
        frontend_dim=model_cfg.frontend_dim,
        num_prefix_tokens=model_cfg.num_prefix_tokens,
    )
    return ShardedLoader(cfg, host_index=host_index, num_hosts=num_hosts, start_step=start_step)
