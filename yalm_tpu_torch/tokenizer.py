"""Trie tokenizer over the packed checkpoint vocabulary.

The port's copy of the pure-Python path of `yalm_tpu/tokenizer.py`: the
vocab ships inside the checkpoint as one NUL-delimited byte tensor
("tokenizer.tokens", written by the converter); encoding is greedy
longest-prefix match over a byte trie with single-byte fallback to the
<0xNN> tokens; decoding handles sentencepiece's leading-space-after-BOS rule
and byte-fallback pieces. Where the native library (`yalm_tpu_torch/native`)
is built, its C++ trie encodes instead, and its exact BPE where the
checkpoint carries merges; `Tokenizer.native` says which path encodes.

When the checkpoint carries merge ranks ("tokenizer.merges", written by the
converter from tokenizer.json), encode upgrades to EXACT rank-based BPE:
added-token extraction, then the recorded pre-tokenizer (sentencepiece
Metaspace or GPT-2 ByteLevel regex), then lowest-rank-first pair merging —
byte-exact parity with HF `tokenizers` everywhere, not just where greedy
longest-match happens to agree (the reference's tokenizer is greedy-only,
src/tokenizer.cpp:57-94; this strictly surpasses it).

Unlike the reference (std::string / char), everything here is explicit
`bytes` — exact byte-level parity with no encoding ambiguity.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from . import native as native_lib

# Tokens that terminate a chat turn; any of these acts as end-of-turn
# (reference src/tokenizer.cpp:22).
_EOT_MARKERS = (b"<|eot_id|>", b"<|end|>", b"<|im_end|>")

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _gpt2_pretok(text: str) -> list[str]:
    """The GPT-2 ByteLevel regex pre-tokenizer, hand-rolled (Python `re`
    has no \\p{L}/\\p{N} classes). Pattern, with leftmost-alternation
    semantics: 's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+ — a whitespace run before a word
    keeps its LAST space attached to the word."""
    def is_l(c):
        return unicodedata.category(c).startswith("L")

    def is_n(c):
        return unicodedata.category(c).startswith("N")

    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            hit = next((s for s in _CONTRACTIONS if text.startswith(s, i)),
                       None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
        j = i + 1 if (c == " " and i + 1 < n) else i
        if j < n and is_l(text[j]):
            k = j
            while k < n and is_l(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if j < n and is_n(text[j]):
            k = j
            while k < n and is_n(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if j < n and not text[j].isspace():
            k = j
            while k < n and not text[k].isspace() and not is_l(text[k]) \
                    and not is_n(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace: \s+(?!\S) leaves the run's last char for the next
        # token's optional-space prefix; a lone \s before non-space falls
        # through to plain \s+
        k = i
        while k < n and text[k].isspace():
            k += 1
        if k == n or k - i > 1:
            stop = k if k == n else k - 1
            out.append(text[i:stop])
            i = stop
        else:
            out.append(text[i:k])
            i = k
    return out


def split_vocab(tokens_blob: bytes) -> list[bytes]:
    """Split the packed NUL-delimited vocab tensor into per-token bytes.

    Mirrors the scan in reference src/tokenizer.cpp:10-18: tokens are
    NUL-terminated; the converter replaced any genuine NUL bytes with BEL.
    """
    # The blob ends with a terminator; split drops the trailing empty piece.
    parts = tokens_blob.split(b"\0")
    if parts and parts[-1] == b"":
        parts.pop()
    return parts


def _llama3_pretok(text: str) -> list[str]:
    """The Llama-3 (tiktoken-lineage) pre-tokenizer regex, hand-rolled:
    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}|
    ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+
    Differences vs GPT-2: case-insensitive contractions, ANY single
    non-newline non-alnum char may prefix a letter run, digits chunk in
    threes, punct swallows trailing newlines, newline runs coalesce."""
    def is_l(c):
        return unicodedata.category(c).startswith("L")

    def is_n(c):
        return unicodedata.category(c).startswith("N")

    def is_nl(c):
        return c in "\r\n"

    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'" and i + 1 < n:
            low = text[i:i + 3].lower()
            hit = next((s for s in _CONTRACTIONS if low.startswith(s)), None)
            if hit:
                out.append(text[i:i + len(hit)])
                i += len(hit)
                continue
        # [^\r\n\p{L}\p{N}]?\p{L}+ — greedy optional prefix first
        if not is_nl(c) and not is_l(c) and not is_n(c) and i + 1 < n \
                and is_l(text[i + 1]):
            k = i + 1
            while k < n and is_l(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if is_l(c):
            k = i
            while k < n and is_l(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # \p{N}{1,3}
        if is_n(c):
            k = i
            while k < n and k - i < 3 and is_n(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        #  ?[^\s\p{L}\p{N}]+[\r\n]*
        j = i + 1 if (c == " " and i + 1 < n) else i
        if j < n and not text[j].isspace() and not is_l(text[j]) \
                and not is_n(text[j]):
            k = j
            while k < n and not text[k].isspace() and not is_l(text[k]) \
                    and not is_n(text[k]):
                k += 1
            while k < n and is_nl(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # \s*[\r\n]+ — ends right after the run's LAST newline char
        k = i
        last_nl = -1
        while k < n and text[k].isspace():
            if is_nl(text[k]):
                last_nl = k
            k += 1
        if last_nl >= 0:
            out.append(text[i:last_nl + 1])
            i = last_nl + 1
            continue
        # \s+(?!\S) then \s+ (identical to the GPT-2 tail)
        if k == n or k - i > 1:
            stop = k if k == n else k - 1
            out.append(text[i:stop])
            i = stop
        else:
            out.append(text[i:k])
            i = k
    return out


class Tokenizer:
    def __init__(self, vocab: list[bytes], bos_id: int, eos_id: int,
                 merges: np.ndarray | None = None,
                 added: np.ndarray | None = None, pretok: str = "",
                 native: bool | None = None):
        """merges: (M, 2) int32 vocab-id pairs in rank order (from
        "tokenizer.merges"); added: (A,) int32 added-token ids; pretok:
        "metaspace:<scheme>" | "bytelevel[:prefix]". With merges present,
        encode runs exact rank-based BPE; otherwise the reference's greedy
        longest-match. native: True encodes in C++ and raises if the native
        library is not built; False in Python; None in C++ where the
        library is built."""
        self.vocab = vocab
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.eot_id = -1
        self.byte_fallback_start = -1
        for i, tok in enumerate(vocab):
            if tok == b"<0x00>":
                self.byte_fallback_start = i
            elif tok in _EOT_MARKERS:
                self.eot_id = i

        # byte trie: nested dicts keyed by int byte value; token id under key -1
        self._trie: dict = {}
        for i, word in enumerate(vocab):
            node = self._trie
            for b in word:
                node = node.setdefault(b, {})
            node[-1] = i

        # exact-BPE machinery (lowest id wins byte-string collisions: merge
        # sides refer to the trained model vocab at the low ids)
        self._ranks: dict | None = None
        self.pretok = pretok
        if merges is not None and len(merges):
            piece_id: dict[bytes, int] = {}
            for i, b in enumerate(vocab):
                piece_id.setdefault(b, i)
            self._piece_id = piece_id
            self._ranks = {}
            self._pair_out = {}
            for rank, (li, ri) in enumerate(np.asarray(merges)):
                li, ri = int(li), int(ri)
                out_id = piece_id.get(vocab[li] + vocab[ri])
                if out_id is None or (li, ri) in self._ranks:
                    continue
                self._ranks[(li, ri)] = rank
                self._pair_out[(li, ri)] = out_id
            self._byte_ids = {b: piece_id.get(bytes([b])) for b in range(256)}
            added_ids = {int(i) for i in (added if added is not None else [])}
            self._added = sorted(((vocab[i], i) for i in added_ids),
                                 key=lambda t: -len(t[0]))
            # HF's BPE byte_fallback only consults the MODEL vocab: <0xNN>
            # pieces that arrived as ADDED tokens are ignored and unknown
            # chars are dropped (unk_token=None). Mirror that exactly.
            self._bpe_fallback = (self.byte_fallback_start >= 0
                                  and self.byte_fallback_start not in added_ids)

        # the native trie over the same pieces, its BPE tables beside it; a
        # loaded library's errors raise
        self._native = None
        if native or (native is None and native_lib.loaded()):
            self._native = native_lib.NativeTrie(b"".join(v + b"\0" for v in vocab))
            if self._ranks is not None:
                self._native.set_bpe(np.asarray(merges, np.int32), added, pretok)

    @property
    def native(self) -> bool:
        """True when the C++ path encodes."""
        return self._native is not None

    @classmethod
    def from_yalm(cls, yf, native: bool | None = None) -> "Tokenizer":
        """Construct from a loaded checkpoint (codec.YalmFile)."""
        blob = np.asarray(yf.tensors["tokenizer.tokens"]).tobytes()
        merges = yf.tensors.get("tokenizer.merges")
        added = yf.tensors.get("tokenizer.added")
        return cls(split_vocab(blob),
                   bos_id=int(yf.metadata["bos_token_id"]),
                   eos_id=int(yf.metadata["eos_token_id"]),
                   merges=None if merges is None else np.asarray(merges),
                   added=None if added is None else np.asarray(added),
                   pretok=yf.metadata.get("tokenizer_pretok", ""), native=native)

    def encode(self, text: str | bytes, bos: bool = False) -> list[int]:
        """Exact BPE when the checkpoint carries merges; else greedy
        longest-prefix-match with byte fallback (reference
        src/tokenizer.cpp:57-94)."""
        data = text.encode("utf-8") if isinstance(text, str) else text
        out: list[int] = []
        if bos:
            out.append(self.bos_id)
        if self._ranks is not None:
            if self._native is not None:
                out.extend(self._native.encode_bpe(data))
                return out
            pos = 0
            for seg, tid in self._split_added(data):
                if tid is not None:
                    pos += len(self.vocab[tid])
                    out.append(tid)
                    continue
                for word in self._pretok_words(seg, first=(pos == 0)):
                    out.extend(self._bpe_word(word))
                pos += len(seg)
            return out
        out.extend(self._greedy(data) if self._native is None else self._native.encode(data))
        return out

    def _greedy(self, data: bytes) -> list[int]:
        out: list[int] = []
        i, n = 0, len(data)
        while i < n:
            node = self._trie
            best_id, best_len = -1, 0
            j = i
            while j < n:
                nxt = node.get(data[j])
                if nxt is None:
                    break
                node = nxt
                j += 1
                tid = node.get(-1)
                if tid is not None:
                    best_id, best_len = tid, j - i
            if best_id < 0:
                if self.byte_fallback_start >= 0:
                    out.append(data[i] + self.byte_fallback_start)
                i += 1  # unencodable byte with no fallback vocab: dropped
            else:
                out.append(best_id)
                i += best_len
        return out

    # -- exact BPE ------------------------------------------------------
    def _split_added(self, data: bytes):
        """Leftmost-longest added-token extraction (HF AddedVocabulary):
        yields (segment_bytes, None) and (b"", token_id) pieces in order."""
        i, start, n = 0, 0, len(data)
        while i < n:
            hit = None
            for piece, tid in self._added:
                if piece and data.startswith(piece, i):
                    hit = (piece, tid)
                    break  # sorted longest-first
            if hit is None:
                i += 1
                continue
            if i > start:
                yield data[start:i], None
            yield b"", hit[1]
            i += len(hit[0])
            start = i
        if start < n:
            yield data[start:], None

    def _pretok_words(self, seg: bytes, first: bool = True) -> list[bytes]:
        kind = self.pretok.split(":", 1)[0]
        if kind == "metaspace":
            scheme = self.pretok.split(":", 1)[1] if ":" in self.pretok \
                else "always"
            # HF Metaspace: 'always' prepends to EVERY split segment,
            # 'first' only to the segment at offset 0 of the whole text
            # (a segment AFTER an added token gets no prefix)
            prepend = (scheme == "always" or (scheme == "first" and first))
            if prepend and not seg.startswith(b" "):
                seg = b" " + seg
            # split BEFORE every space (sentencepiece ▁ merges with what
            # follows); consecutive spaces each start a new piece
            words, start = [], 0
            for i in range(1, len(seg)):
                if seg[i] == 0x20:
                    words.append(seg[start:i])
                    start = i
            if seg[start:] or not words:
                words.append(seg[start:])
            return [w for w in words if w]
        if kind in ("bytelevel", "llama3"):
            text = seg.decode("utf-8", errors="surrogateescape")
            if self.pretok.endswith(":prefix") and text and \
                    not text.startswith(" "):
                text = " " + text
            scan = _llama3_pretok if kind == "llama3" else _gpt2_pretok
            return [w.encode("utf-8", errors="surrogateescape")
                    for w in scan(text)]
        return [seg] if seg else []

    def _bpe_word(self, word: bytes) -> list[int]:
        """Rank-based BPE over one pre-tokenized word. Symbols are unicode
        chars (metaspace/sentencepiece lineage) or single bytes (bytelevel);
        chars outside the vocab cannot merge and byte-fallback at the end."""
        syms: list[tuple[int | None, bytes]] = []
        if self.pretok.startswith(("bytelevel", "llama3")):
            for b in word:
                syms.append((self._byte_ids[b], bytes([b])))
        else:
            text = word.decode("utf-8", errors="surrogateescape")
            for ch in text:
                cb = ch.encode("utf-8", errors="surrogateescape")
                syms.append((self._piece_id.get(cb), cb))
        while len(syms) > 1:
            best_rank, best_i = None, -1
            for i in range(len(syms) - 1):
                a, b = syms[i][0], syms[i + 1][0]
                if a is None or b is None:
                    continue
                r = self._ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            a, b = syms[best_i], syms[best_i + 1]
            syms[best_i:best_i + 2] = [
                (self._pair_out[(a[0], b[0])], a[1] + b[1])]
        out: list[int] = []
        for tid, sb in syms:
            if tid is not None:
                out.append(tid)
            elif self._bpe_fallback:
                out.extend(x + self.byte_fallback_start for x in sb)
            # else: unknown unit dropped (HF BPE with unk_token=None)
        return out

    def decode_one(self, prev_token: int, token: int) -> bytes:
        """Decode one token in context (reference src/tokenizer.cpp:44-55)."""
        piece = self.vocab[token]
        # sentencepiece strips the leading space of the first piece after BOS
        if prev_token == self.bos_id and piece.startswith(b" "):
            return piece[1:]
        if (self.byte_fallback_start >= 0
                and token >= self.byte_fallback_start
                and token - self.byte_fallback_start < 256):
            return bytes([token - self.byte_fallback_start])
        return piece

    def decode(self, tokens: list[int], prev: int | None = None) -> bytes:
        out = []
        p = prev if prev is not None else self.bos_id
        for t in tokens:
            out.append(self.decode_one(p, t))
            p = t
        return b"".join(out)

    def encoding_to_debug_string(self, encoding: list[int]) -> str:
        """[piece:id] rendering for CLI logs (reference src/tokenizer.cpp:96-108)."""
        parts = []
        for tid in encoding:
            if tid == self.bos_id:
                parts.append(f"[<s>:{tid}]")
            elif tid == self.eos_id:
                parts.append(f"[</s>:{tid}]")
            else:
                piece = self.vocab[tid].decode("utf-8", errors="replace")
                parts.append(f"[{piece}:{tid}]")
        return "".join(parts)
