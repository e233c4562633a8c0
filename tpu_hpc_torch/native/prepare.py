"""Text -> token-corpus preparation: the step before pretraining.

Port of the JAX package's ``native/prepare.py``, unchanged in what it
writes: tokenize raw text files ONCE into the flat binary corpus format
(``dataloader.write_token_dataset``), then every rank trains from the
mmap'd file through the C++ prefetch ring (``NativeTokenDataset``,
``python -m tpu_hpc_torch.train --tokens-file``) with zero tokenization
cost in the hot path. The same inputs and tokenizer give the same file,
byte for byte, as the JAX package's.

Two tokenizers:

- ``byte`` (default): UTF-8 bytes as token ids 0..255 -- no vocab
  files, no network, deterministic, reversible; id 256 ends a document.
- ``hf:<path>``: any HuggingFace tokenizer loadable from a LOCAL
  directory via ``transformers.AutoTokenizer.from_pretrained``, imported
  only when asked for; nothing requires a download.

The writer streams: chunks are encoded and appended as they are read,
so a corpus larger than RAM prepares in O(chunk) memory; the header's
token count and max-id words are patched on close.

CLI: ``python -m tpu_hpc_torch.native.prepare FILES... --out corpus.bin``
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from tpu_hpc_torch.native.dataloader import _TOKEN_MAGIC

_HEADER_WORDS = 4  # magic, n_tokens, itemsize, max_id


class TokenDatasetWriter:
    """Append token-id chunks to a corpus file in O(chunk) memory.

    ``vocab_size`` picks the on-disk dtype up front (uint16 when every
    possible id fits, else uint32); the actual max id seen is tracked
    and written to the header on close, so loaders still validate
    against the model's vocab exactly as with the one-shot writer.
    """

    def __init__(self, path: str, vocab_size: int):
        if vocab_size < 1 or vocab_size > 0x100000000:
            raise ValueError(
                f"vocab_size {vocab_size} must be in [1, 2^32]"
            )
        self.path = path
        self.dtype = (
            np.uint16 if vocab_size <= 0x10000 else np.uint32
        )
        self._n = 0
        self._max = 0
        self._vocab = vocab_size
        self._f = open(path, "wb")
        # Placeholder header; n_tokens and max_id patched on close.
        np.asarray(
            [_TOKEN_MAGIC, 0, np.dtype(self.dtype).itemsize, 0],
            np.uint64,
        ).tofile(self._f)

    def append(self, tokens) -> None:
        tokens = np.asarray(tokens)
        if tokens.size == 0:
            return
        if not np.issubdtype(tokens.dtype, np.integer):
            raise ValueError(
                f"tokens must be integers, got {tokens.dtype}"
            )
        lo, hi = int(tokens.min()), int(tokens.max())
        if lo < 0 or hi >= self._vocab:
            raise ValueError(
                f"token id range [{lo}, {hi}] outside vocab_size "
                f"{self._vocab}"
            )
        self._max = max(self._max, hi)
        self._n += tokens.size
        np.ascontiguousarray(tokens, self.dtype).tofile(self._f)

    def close(self) -> str:
        if self._f is None:
            return self.path
        if self._n < 2:
            self._f.close()
            self._f = None
            os.unlink(self.path)
            raise ValueError(
                f"corpus needs at least 2 tokens, got {self._n}"
            )
        self._f.seek(0)
        np.asarray(
            [_TOKEN_MAGIC, self._n, np.dtype(self.dtype).itemsize,
             self._max],
            np.uint64,
        ).tofile(self._f)
        self._f.close()
        self._f = None
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._f is not None:
            # Failed preparation must not leave a truncated corpus
            # that a later open half-trusts.
            self._f.close()
            self._f = None
            if os.path.exists(self.path):
                os.unlink(self.path)
            return False
        self.close()
        return False

    @property
    def n_tokens(self) -> int:
        return self._n


def byte_tokenizer() -> tuple:
    """(encode, vocab_size, eot_id): UTF-8 bytes as ids, no deps.

    Chunk-safe: ``encode(a) + encode(b) == encode(a + b)``, so large
    files can stream through in bounded-size chunks.
    """
    def encode(text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8)

    return encode, 257, 256  # 256 = end-of-text, outside byte range


def hf_tokenizer(path: str) -> tuple:
    """(encode, vocab_size, eot_id) from a LOCAL HF tokenizer dir."""
    if not os.path.isdir(path):
        # from_pretrained would otherwise try to parse this as a hub
        # repo id and fail with a misleading validation error.
        raise ValueError(
            f"hf:{path}: not a local directory -- pass a directory "
            "containing tokenizer files (tokenizer.json etc.)"
        )
    try:
        from transformers import AutoTokenizer
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "hf:<path> tokenizers need the transformers package"
        ) from e
    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    eot = tok.eos_token_id

    def encode(text: str) -> np.ndarray:
        return np.asarray(
            tok.encode(text, add_special_tokens=False), np.int64
        )

    # len(tok) counts added special tokens; vocab_size alone may not.
    return encode, max(len(tok), (eot or 0) + 1), eot


def resolve_tokenizer(spec: str) -> tuple:
    """``byte`` or ``hf:<local-dir>`` -> (encode, vocab_size, eot).

    Byte is *chunk-safe* (splitting text anywhere yields the same
    ids); BPE-family tokenizers are NOT -- a merge spanning a split
    point encodes differently -- so ``prepare_corpus`` streams byte
    corpora in chunks but encodes hf documents whole.
    """
    if spec == "byte":
        return byte_tokenizer()
    if spec.startswith("hf:"):
        return hf_tokenizer(spec[3:])
    raise ValueError(
        f"unknown tokenizer {spec!r}: expected 'byte' or 'hf:<path>'"
    )


def iter_documents(
    paths: List[str], chunk_bytes: int = 1 << 22
) -> Iterator[str]:
    """Yield ~chunk_bytes text pieces from files ('-' = stdin) in
    O(chunk) memory.

    Fixed-size text-mode reads: the codec's incremental decoder
    handles multi-byte UTF-8 at buffer edges, and chunk boundaries
    land at arbitrary character offsets -- only safe for chunk-safe
    tokenizers (see ``resolve_tokenizer``); line-buffered reads would
    re-introduce unbounded memory on newline-free files.
    """
    for p in paths:
        f = sys.stdin if p == "-" else open(
            p, "r", encoding="utf-8", errors="replace"
        )
        try:
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                yield chunk
        finally:
            if f is not sys.stdin:
                f.close()


def prepare_corpus(
    out: str,
    inputs: List[str],
    tokenizer: str = "byte",
    append_eot: bool = True,
    encode: Optional[Callable] = None,
    vocab_size: Optional[int] = None,
    eot_id: Optional[int] = None,
    documents: Optional[Iterable[str]] = None,
    chunk_safe: Optional[bool] = None,
) -> dict:
    """Tokenize ``inputs`` (text files) into the corpus at ``out``.

    Each input FILE is one document; an end-of-text token separates
    documents when the tokenizer defines one (``append_eot``). Pass
    ``encode``/``vocab_size`` directly to use a custom tokenizer
    callable instead of a spec string. Returns a summary dict.

    Chunk-safe tokenizers (byte) stream each file in O(chunk) memory;
    others (BPE changes ids when text is split mid-merge) encode each
    file as one in-memory document. ``chunk_safe`` overrides the
    per-tokenizer default for custom ``encode`` callables.
    """
    if encode is None:
        if chunk_safe is None:
            chunk_safe = tokenizer == "byte"
        encode, vocab_size, eot_id = resolve_tokenizer(tokenizer)
    elif vocab_size is None:
        raise ValueError("custom encode requires vocab_size")
    if chunk_safe is None:
        chunk_safe = False
    with TokenDatasetWriter(out, vocab_size) as w:
        if documents is not None:
            for doc in documents:
                w.append(encode(doc))
                if append_eot and eot_id is not None:
                    w.append(np.asarray([eot_id]))
        else:
            for path in inputs:
                if chunk_safe:
                    for chunk in iter_documents([path]):
                        w.append(encode(chunk))
                elif path == "-":
                    w.append(encode(sys.stdin.read()))
                else:
                    with open(
                        path, "r", encoding="utf-8", errors="replace"
                    ) as f:
                        w.append(encode(f.read()))
                if append_eot and eot_id is not None:
                    w.append(np.asarray([eot_id]))
        n = w.n_tokens
    return {
        "path": out,
        "n_tokens": n,
        "vocab_size": vocab_size,
        "dtype": str(np.dtype(w.dtype)),
        "bytes": os.path.getsize(out),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("inputs", nargs="+",
                   help="text files to tokenize ('-' = stdin); each "
                   "file is one document")
    p.add_argument("--out", required=True,
                   help="output corpus path (.bin)")
    p.add_argument("--tokenizer", default="byte",
                   help="'byte' (default, no deps) or 'hf:<local "
                   "tokenizer dir>'")
    p.add_argument("--no-eot", action="store_true",
                   help="do not append an end-of-text token between "
                   "documents")
    args = p.parse_args(argv)
    info = prepare_corpus(
        args.out, args.inputs, tokenizer=args.tokenizer,
        append_eot=not args.no_eot,
    )
    print(
        f"wrote {info['path']}: {info['n_tokens']:,} tokens "
        f"({info['dtype']}, {info['bytes']:,} bytes, vocab "
        f"{info['vocab_size']})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
