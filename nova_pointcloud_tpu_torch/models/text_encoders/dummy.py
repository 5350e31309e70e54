"""Deterministic hash-based text encoder for bootstrap / tests / benches.

Formalizes the reference's Dummy*/Simple*/Improved* tokenizer-encoder pattern
(`train_newloss.py:625-643`, `test_optimize.py:79-111`, `demo.py:211-291`):
a cheap, checkpoint-free encoder that lets the full pipeline run end-to-end.
Embeddings are deterministic functions of the token strings, so goldens are
stable across runs and hosts.

A copy of ``nova_pointcloud_tpu/models/text_encoders/dummy.py`` (pure numpy):
the port imports nothing of the JAX package, and its output is byte-identical.
"""

import hashlib
from typing import List, Sequence, Tuple

import numpy as np


class DummyTokenizer:
    """Whitespace tokenizer with stable 32-bit hashes as ids."""

    def __init__(self, vocab_size: int = 32768, max_length: int = 32):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, text: str) -> List[int]:
        ids = []
        for word in text.lower().split()[: self.max_length]:
            h = hashlib.md5(word.encode()).digest()
            ids.append(int.from_bytes(h[:4], "little") % self.vocab_size)
        return ids or [0]


class DummyTextEncoder:
    """Maps token ids to fixed pseudo-random embeddings + positional mix."""

    def __init__(self, token_dim: int = 256, num_tokens: int = 32,
                 vocab_size: int = 32768, seed: int = 1234):
        self.token_dim, self.num_tokens = token_dim, num_tokens
        self.tokenizer = DummyTokenizer(vocab_size, num_tokens)
        rng = np.random.RandomState(seed)
        self.table = rng.randn(vocab_size, token_dim).astype(np.float32) * 0.4
        self.pos = rng.randn(num_tokens, token_dim).astype(np.float32) * 0.1

    def encode(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (embeds (B, num_tokens, token_dim), lengths (B,))."""
        out = np.zeros((len(prompts), self.num_tokens, self.token_dim), np.float32)
        lengths = np.zeros((len(prompts),), np.int32)
        for i, p in enumerate(prompts):
            ids = self.tokenizer(p)[: self.num_tokens]
            lengths[i] = len(ids)
            out[i, : len(ids)] = self.table[ids] + self.pos[: len(ids)]
        return out, lengths

    def __call__(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.encode(prompts)
