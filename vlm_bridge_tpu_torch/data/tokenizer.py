"""Tokenizer abstraction (the port's own copy of vlm_bridge_tpu.data.tokenizer,
held equal to it by tests/test_torch_port.py and, for GemmaTokenizer, by
tests/test_torch_hf_loader.py).

Production path: the Gemma tokenizer loaded from a local HF snapshot (zero
egress environments cannot download it). Test/offline path: a deterministic
byte-level tokenizer with the same special-token contract (BOS prepended,
pad == configurable id, EOS available) so the whole pipeline runs hermetically.

Contract (mirrors the reference collate + decode behavior,
reference: src/vlm_bridge/data_pipeline/data_loader.py:64-167 and
model_architecture/language_model.py:219-266):
- encode(text) -> ids WITH leading BOS, truncated to max_length
- decode(ids) strips BOS/EOS/pad
- pad id used for batch padding; attention mask marks real tokens
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


class ByteTokenizer:
    """Hermetic byte-level tokenizer: ids = byte + 3 (0=pad, 1=eos, 2=bos).

    Matches the Gemma special-token ID assignment (pad=0, eos=1, bos=2) so
    tiny-model tests exercise identical control-token logic.
    """

    pad_token_id = 0
    eos_token_id = 1
    bos_token_id = 2
    vocab_size = 259

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.bos_token_id] + [b + 3 for b in text.encode("utf-8")]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - 3 for i in ids
            if i not in (self.pad_token_id, self.eos_token_id, self.bos_token_id)
            and 3 <= i < 259)
        return data.decode("utf-8", errors="replace")


class GemmaTokenizer:
    """HF Gemma tokenizer from a local snapshot (adds BOS automatically).

    The JAX package loads it with transformers' AutoTokenizer; the port
    imports no transformers, so this reads the snapshot's files itself:
    `tokenizer.json` through the `tokenizers` library (the fast tokenizer
    AutoTokenizer wraps), the special tokens from `special_tokens_map.json`
    / `tokenizer_config.json`, and the config's clean_up_tokenization_spaces."""

    def __init__(self, path: str | Path):
        import json

        from tokenizers import Tokenizer

        path = Path(path)
        self._tok = Tokenizer.from_file(str(path / "tokenizer.json"))
        special = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            if (path / name).exists():
                special.update(json.loads((path / name).read_text()))
        self._cleanup = bool(special.get("clean_up_tokenization_spaces", False))

        def token_id(key):
            tok = special.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            return None if tok is None else self._tok.token_to_id(tok)

        self.eos_token_id = token_id("eos_token")
        self.bos_token_id = token_id("bos_token")
        # pad = eos convention from the reference (data_loader.py:76-77)
        pad = token_id("pad_token")
        self.pad_token_id = self.eos_token_id if pad is None else pad
        self.vocab_size = self._tok.get_vocab_size(with_added_tokens=True)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = self._tok.encode(text).ids
        return ids if max_length is None else ids[:max_length]

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode(list(ids), skip_special_tokens=True)
        if self._cleanup:   # transformers' clean_up_tokenization
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text


def get_tokenizer(path: Optional[str] = None):
    """Gemma tokenizer if a local path is given, else the hermetic fallback."""
    if path:
        return GemmaTokenizer(path)
    return ByteTokenizer()


def batch_encode(
    tokenizer,
    texts: Sequence[str],
    max_length: int,
    buckets: Sequence[int] = (),
    append_eos: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize + pad to a fixed-shape bucket.

    Unlike the reference's dynamic per-batch padding (data_loader.py:155-161),
    batches are padded to the smallest bucket >= the batch max length so jit
    sees a handful of static shapes instead of recompiling per batch.
    Returns (input_ids [B, L], attn_mask [B, L]) int32.

    append_eos=True puts EOS INSIDE the attention/loss mask. The reference
    never appends EOS; its stop-token signal came entirely from the pad=eos
    convention plus the pad-in-loss bug (reference data_loader.py:76-77 +
    core_training_loop.py:52-55) — every trailing pad position trained the
    model to emit EOS. With that bug fixed (shift_labels mask_pad=True),
    an explicit in-mask EOS is the intended version of the same signal;
    without it the model cannot learn to terminate captions at all.
    Truncated-at-max_length captions keep no EOS (standard practice).
    """
    encoded = [tokenizer.encode(t, max_length=max_length) for t in texts]
    if append_eos:
        encoded = [
            e + [tokenizer.eos_token_id] if len(e) < max_length else e
            for e in encoded]
    longest = max(len(e) for e in encoded)
    L = max_length
    for b in sorted(buckets):
        if longest <= b <= max_length:
            L = b
            break
    ids = np.full((len(encoded), L), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((len(encoded), L), np.int32)
    for i, e in enumerate(encoded):
        e = e[:L]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return ids, mask
