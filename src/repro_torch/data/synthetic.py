"""Synthetic + text data pipelines for training and serving (the JAX
package's ``data/synthetic.py``; numpy only, so both packages yield the
same arrays for the same seed).

The synthetic stream generates structured sequences (Zipf-distributed
n-gram chains) so that the masked-diffusion loss is genuinely learnable
(the model must exploit bidirectional context), rather than pure noise.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokens:
    """Markov-chain token stream with Zipf unigram prior."""

    def __init__(self, vocab_size: int, seed: int = 0, order: int = 2,
                 branch: int = 4):
        self.vocab = max(vocab_size - 1, 2)  # reserve mask id
        self.rng = np.random.default_rng(seed)
        self.order = order
        self.branch = branch
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def _next(self, context: np.ndarray) -> np.ndarray:
        # Deterministic successor set per context hash + random pick.
        h = (context @ (np.arange(self.order) * 2654435761 + 1)) \
            % (2 ** 31)
        choices = (h[:, None] * (np.arange(self.branch) + 1)) % self.vocab
        pick = self.rng.integers(0, self.branch, size=h.shape[0])
        return choices[np.arange(h.shape[0]), pick].astype(np.int32)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        out = np.zeros((batch_size, seq_len), np.int32)
        out[:, : self.order] = self.rng.choice(
            self.vocab, size=(batch_size, self.order), p=self.unigram)
        for t in range(self.order, seq_len):
            out[:, t] = self._next(out[:, t - self.order: t])
        return out


def token_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    gen = SyntheticTokens(cfg.vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        batch: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            frames = rng.standard_normal(
                (batch_size, seq_len, cfg.d_model)).astype(np.float32) * 0.02
            batch["frames"] = frames
            batch["targets"] = gen.batch(batch_size, seq_len)
        elif cfg.frontend == "vision":
            f = min(cfg.frontend_tokens, max(seq_len // 4, 1))
            text_len = seq_len - f
            batch["tokens"] = gen.batch(batch_size, text_len)
            batch["patches"] = rng.standard_normal(
                (batch_size, f, cfg.d_model)).astype(np.float32) * 0.02
        else:
            batch["tokens"] = gen.batch(batch_size, seq_len)
        yield batch


class ByteTokenizer:
    """Trivial byte-level tokenizer for the text examples."""

    def __init__(self, vocab_size: int):
        assert vocab_size >= 258
        self.vocab_size = vocab_size
        self.bos, self.eos = 256, 257

    def encode(self, text: str, seq_len: Optional[int] = None) -> np.ndarray:
        ids = [self.bos] + list(text.encode("utf-8"))[: (seq_len or 1 << 30)
                                                      - 2] + [self.eos]
        if seq_len:
            ids = ids[:seq_len] + [self.eos] * max(0, seq_len - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        body = bytes(int(i) for i in ids if int(i) < 256)
        return body.decode("utf-8", errors="replace")


def text_batches(cfg: ModelConfig, corpus: str, batch_size: int,
                 seq_len: int, seed: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    tok = ByteTokenizer(cfg.vocab_size)
    data = tok.encode(corpus)
    rng = np.random.default_rng(seed)
    while True:
        starts = rng.integers(0, max(len(data) - seq_len, 1),
                              size=batch_size)
        rows = np.stack([
            np.resize(data[s: s + seq_len], seq_len) for s in starts])
        yield {"tokens": rows.astype(np.int32)}
