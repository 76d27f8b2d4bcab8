"""Tokenizers: native char/bpe/unigram with SentencePiece conventions.

The port's own copy of the JAX package's ``data/tokenizer.py``, line for
line, with its imports pointed at ``tsasr_torch``.

The reference wraps the SentencePiece C++ library
(``vendor/speechbrain/speechbrain/tokenizers/SentencePiece.py:20-465``)
with the recipe default ``token_type=char`` and ``vocab_size=29``
(``hparams/LibriSpeechMix/conformer-t_scratch.yaml:76-79``) but supports
all three SentencePiece model types (``SentencePiece.py:279-314`` just
forwards ``model_type`` to the spm trainer). SentencePiece is not
available in this environment, so all three are native implementations
sharing SentencePiece-compatible conventions:

- text is pre-tokenized by replacing spaces with the word-boundary marker
  "▁" and prepending one at the start of the sentence;
- ``<unk>`` sits at ``unk_id``; every other id is a learned piece;
- ``decode`` joins pieces and turns word-boundary markers back into
  spaces.

Model types:

- ``char``     — inventory = all characters by descending frequency.
- ``bpe``      — greedy pair-merge training (Sennrich et al. 2016), the
                 same algorithm spm's ``--model_type=bpe`` runs; encoding
                 replays merges in rank order.
- ``unigram``  — Kudo 2018: seed-substring inventory, EM over the
                 segmentation lattice (forward/backward expected counts),
                 prune lowest-likelihood-contribution pieces; encoding is
                 Viterbi max-probability segmentation.

Training is a one-time host-side step in the experiment setup (reference
``train_librispeechmix_*.py`` builds the tokenizer before dataio), so
pure Python is the right altitude — no device code involved.
"""

import json
import math
import os
from collections import Counter

WORD_BOUNDARY = "▁"


class CharTokenizer:
    """Char-level tokenizer with SentencePiece char-model conventions."""

    def __init__(self, pieces, unk_id=0):
        self.pieces = list(pieces)
        self.unk_id = unk_id
        self._piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        if self.pieces[unk_id] != "<unk>":
            raise ValueError("pieces[unk_id] must be '<unk>'")

    # ------------------------------------------------------------ factory
    @classmethod
    def train(cls, texts, vocab_size=None, unk_id=0, character_coverage=1.0):
        """Build the inventory from an iterable of training sentences."""
        counter = Counter()
        for text in texts:
            counter.update(_pretokenize(text))
        # coverage: drop the rarest chars until the kept mass >= coverage
        items = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        if character_coverage < 1.0:
            total = sum(counter.values())
            kept, mass = [], 0
            for ch, cnt in items:
                if mass / total >= character_coverage:
                    break
                kept.append((ch, cnt))
                mass += cnt
            items = kept
        chars = [ch for ch, _ in items]
        if vocab_size is not None:
            if len(chars) + 1 > vocab_size:
                chars = chars[: vocab_size - 1]
            elif len(chars) + 1 < vocab_size:
                raise ValueError(
                    f"vocab_size={vocab_size} but only {len(chars) + 1} "
                    f"pieces found; with token_type=char, vocab_size must "
                    f"equal the number of found characters + 1")
        pieces = chars[:unk_id] + ["<unk>"] + chars[unk_id:]
        return cls(pieces, unk_id=unk_id)

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return cls(obj["pieces"], unk_id=obj["unk_id"])

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"pieces": self.pieces, "unk_id": self.unk_id}, f,
                      ensure_ascii=False, indent=2)

    # ------------------------------------------------------------- encode
    @property
    def vocab_size(self):
        return len(self.pieces)

    def encode_as_ids(self, text):
        return [self._piece_to_id.get(ch, self.unk_id)
                for ch in _pretokenize(text)]

    def encode_as_pieces(self, text):
        return list(_pretokenize(text))

    def decode_ids(self, ids):
        text = "".join(self.pieces[i] for i in ids
                       if 0 <= i < len(self.pieces) and i != self.unk_id)
        return text.replace(WORD_BOUNDARY, " ").strip()

    def decode_ids_to_words(self, ids):
        """Token ids -> list of words (the recipe's decode_from_list)."""
        decoded = self.decode_ids(ids)
        return decoded.split(" ") if decoded else [""]

    def __call__(self, batch_ids, task="decode_from_list"):
        """Batch interface mirroring the reference SentencePiece wrapper."""
        if task == "decode_from_list":
            return [self.decode_ids_to_words(ids) for ids in batch_ids]
        if task == "encode":
            return [self.encode_as_ids(text) for text in batch_ids]
        raise ValueError(f"Unknown task: {task}")


def _pretokenize(text):
    """SentencePiece-style pre-tokenization for char models."""
    text = " ".join(text.split())  # normalize whitespace
    return WORD_BOUNDARY + text.replace(" ", WORD_BOUNDARY)


def _word_counts(texts):
    """Unique ▁-prefixed words with counts (training works per-word)."""
    counter = Counter()
    for text in texts:
        for word in text.split():
            counter[WORD_BOUNDARY + word] += 1
    return counter


class _PieceTokenizerBase:
    """Shared id/piece bookkeeping + batch interface for bpe/unigram."""

    model_type = None

    def __init__(self, pieces, unk_id=0):
        self.pieces = list(pieces)
        self.unk_id = unk_id
        self._piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        if self.pieces[unk_id] != "<unk>":
            raise ValueError("pieces[unk_id] must be '<unk>'")

    @property
    def vocab_size(self):
        return len(self.pieces)

    def _segment_word(self, word):  # -> list of piece strings
        raise NotImplementedError

    def encode_as_pieces(self, text):
        pieces = []
        text = " ".join(text.split())
        for word in text.split(" "):
            if word:
                pieces.extend(self._segment_word(WORD_BOUNDARY + word))
        return pieces

    def encode_as_ids(self, text):
        return [self._piece_to_id.get(p, self.unk_id)
                for p in self.encode_as_pieces(text)]

    def decode_ids(self, ids):
        text = "".join(self.pieces[i] for i in ids
                       if 0 <= i < len(self.pieces) and i != self.unk_id)
        return text.replace(WORD_BOUNDARY, " ").strip()

    def decode_ids_to_words(self, ids):
        decoded = self.decode_ids(ids)
        return decoded.split(" ") if decoded else [""]

    def __call__(self, batch_ids, task="decode_from_list"):
        if task == "decode_from_list":
            return [self.decode_ids_to_words(ids) for ids in batch_ids]
        if task == "encode":
            return [self.encode_as_ids(text) for text in batch_ids]
        raise ValueError(f"Unknown task: {task}")

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"model_type": self.model_type, "pieces": self.pieces,
                   "unk_id": self.unk_id}
        payload.update(self._save_extra())
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False, indent=2)

    def _save_extra(self):
        return {}


class BpeTokenizer(_PieceTokenizerBase):
    """Byte-pair-encoding tokenizer (spm ``--model_type=bpe`` semantics).

    Training greedily merges the most frequent adjacent symbol pair
    (ties broken lexicographically for determinism) until the inventory
    reaches ``vocab_size``; encoding replays the merges in rank order.
    """

    model_type = "bpe"

    def __init__(self, pieces, merges, unk_id=0):
        super().__init__(pieces, unk_id=unk_id)
        # merges: list of (left, right) in rank order
        self.merges = [tuple(m) for m in merges]
        self._merge_rank = {m: r for r, m in enumerate(self.merges)}

    @classmethod
    def train(cls, texts, vocab_size, unk_id=0,
              max_sentencepiece_length=16):
        words = _word_counts(texts)
        # working state: each unique word as a tuple of symbols
        symbolized = {w: tuple(w) for w in words}
        chars = Counter()
        for w, cnt in words.items():
            for ch in w:
                chars[ch] += cnt
        base = [ch for ch, _ in
                sorted(chars.items(), key=lambda kv: (-kv[1], kv[0]))]
        n_target_merges = max(0, vocab_size - 1 - len(base))
        merges = []
        for _ in range(n_target_merges):
            pair_counts = Counter()
            for w, syms in symbolized.items():
                cnt = words[w]
                for a, b in zip(syms, syms[1:]):
                    pair_counts[(a, b)] += cnt
            if not pair_counts:
                break
            best = max(pair_counts.items(),
                       key=lambda kv: (kv[1], tuple(map(str, kv[0]))))
            (left, right), best_cnt = best
            if best_cnt < 2 or len(left + right) > max_sentencepiece_length:
                break
            merged = left + right
            merges.append((left, right))
            for w, syms in symbolized.items():
                if merged not in w:
                    continue
                out, i = [], 0
                while i < len(syms):
                    if (i + 1 < len(syms) and syms[i] == left
                            and syms[i + 1] == right):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                symbolized[w] = tuple(out)
        # distinct merge pairs can yield the same string (e.g. 'ab'+'c'
        # and 'a'+'bc'); keep every merge for encoding but add each
        # piece string once so id<->piece stays a bijection
        pieces, seen = list(base), set(base)
        for a, b in merges:
            if a + b not in seen:
                seen.add(a + b)
                pieces.append(a + b)
        pieces = pieces[:unk_id] + ["<unk>"] + pieces[unk_id:]
        return cls(pieces, merges, unk_id=unk_id)

    def _segment_word(self, word):
        syms = list(word)
        while len(syms) > 1:
            best_rank, best_i = None, None
            for i, pair in enumerate(zip(syms, syms[1:])):
                rank = self._merge_rank.get(pair)
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        return syms

    def _save_extra(self):
        return {"merges": [list(m) for m in self.merges]}

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return cls(obj["pieces"], obj["merges"], unk_id=obj["unk_id"])


class UnigramTokenizer(_PieceTokenizerBase):
    """Unigram-LM tokenizer (Kudo 2018; spm ``--model_type=unigram``).

    Training: seed the inventory with frequent substrings, run EM on the
    segmentation lattice (forward/backward over each word gives expected
    piece counts), then iteratively prune the pieces whose removal costs
    the least likelihood until the inventory fits ``vocab_size``.
    Single characters are never pruned so every string stays encodable.
    """

    model_type = "unigram"

    def __init__(self, pieces, log_probs, unk_id=0):
        super().__init__(pieces, unk_id=unk_id)
        self.log_probs = list(log_probs)
        self._piece_logp = {p: lp for p, lp in zip(self.pieces,
                                                   self.log_probs)
                            if p != "<unk>"}
        self._max_len = max((len(p) for p in self._piece_logp), default=1)

    # -------------------------------------------------------------- train
    @classmethod
    def train(cls, texts, vocab_size, unk_id=0,
              max_sentencepiece_length=16, seed_factor=8, n_em_iters=2,
              prune_frac=0.25):
        words = _word_counts(texts)
        chars = {ch for w in words for ch in w}
        # seed: frequent substrings scored by count * length
        sub_counts = Counter()
        for w, cnt in words.items():
            L = min(len(w), max_sentencepiece_length)
            for i in range(len(w)):
                for j in range(i + 1, min(len(w), i + L) + 1):
                    sub_counts[w[i:j]] += cnt
        seed_size = max(vocab_size * seed_factor, len(chars) + 1)
        scored = sorted(((cnt * len(s), s) for s, cnt in sub_counts.items()
                         if len(s) > 1),
                        key=lambda t: (-t[0], t[1]))
        vocab = {s for _, s in scored[:seed_size - len(chars)]} | chars
        total_mass = sum(sub_counts.values())
        logp = {s: math.log(sub_counts[s] / total_mass) for s in vocab}
        target = vocab_size - 1  # room for <unk>
        while True:
            for _ in range(n_em_iters):
                logp = cls._em_step(words, vocab, logp)
            if len(vocab) <= target:
                break
            # prune: drop pieces with the smallest likelihood contribution
            contrib = cls._piece_contributions(words, vocab, logp)
            prunable = sorted(
                (p for p in vocab if len(p) > 1),
                key=lambda p: (contrib.get(p, 0.0), p))
            n_drop = min(max(1, int(len(vocab) * prune_frac)),
                         len(vocab) - target, len(prunable))
            if n_drop <= 0:
                break
            for p in prunable[:n_drop]:
                vocab.discard(p)
                logp.pop(p, None)
        order = sorted(vocab, key=lambda p: (-logp[p], p))
        pieces = order[:unk_id] + ["<unk>"] + order[unk_id:]
        lps = ([logp[p] for p in order[:unk_id]] + [0.0]
               + [logp[p] for p in order[unk_id:]])
        return cls(pieces, lps, unk_id=unk_id)

    @staticmethod
    def _lattice_pass(word, vocab, logp, max_len):
        """Forward log-partition per prefix; returns (alpha, arcs)."""
        n = len(word)
        alpha = [-math.inf] * (n + 1)
        alpha[0] = 0.0
        arcs = []  # (start, end, piece, piece_logp)
        for end in range(1, n + 1):
            for start in range(max(0, end - max_len), end):
                piece = word[start:end]
                lp = logp.get(piece)
                if lp is None or alpha[start] == -math.inf:
                    continue
                arcs.append((start, end, piece, lp))
                score = alpha[start] + lp
                m = max(alpha[end], score)
                alpha[end] = m + math.log(math.exp(alpha[end] - m)
                                          + math.exp(score - m))
        return alpha, arcs

    @classmethod
    def _em_step(cls, words, vocab, logp):
        max_len = max(len(p) for p in vocab)
        expected = Counter()
        for w, cnt in words.items():
            alpha, arcs = cls._lattice_pass(w, vocab, logp, max_len)
            n = len(w)
            if alpha[n] == -math.inf:
                continue
            beta = [-math.inf] * (n + 1)
            beta[n] = 0.0
            for start, end, piece, lp in reversed(arcs):
                score = lp + beta[end]
                m = max(beta[start], score)
                beta[start] = m + math.log(math.exp(beta[start] - m)
                                           + math.exp(score - m))
            for start, end, piece, lp in arcs:
                post = alpha[start] + lp + beta[end] - alpha[n]
                if post > -30:
                    expected[piece] += cnt * math.exp(post)
        total = sum(expected.values())
        floor = math.log(1e-10)
        return {p: (math.log(expected[p] / total)
                    if expected.get(p, 0.0) > 0 else floor)
                for p in vocab}

    @classmethod
    def _piece_contributions(cls, words, vocab, logp):
        """Likelihood mass routed through each piece (prune score)."""
        max_len = max(len(p) for p in vocab)
        contrib = Counter()
        for w, cnt in words.items():
            alpha, arcs = cls._lattice_pass(w, vocab, logp, max_len)
            n = len(w)
            if alpha[n] == -math.inf:
                continue
            beta = [-math.inf] * (n + 1)
            beta[n] = 0.0
            for start, end, piece, lp in reversed(arcs):
                score = lp + beta[end]
                m = max(beta[start], score)
                beta[start] = m + math.log(math.exp(beta[start] - m)
                                           + math.exp(score - m))
            for start, end, piece, lp in arcs:
                post = alpha[start] + lp + beta[end] - alpha[n]
                if post > -30:
                    contrib[piece] += cnt * math.exp(post) * (-lp)
        return contrib

    # ------------------------------------------------------------- encode
    def _segment_word(self, word):
        n = len(word)
        best = [-math.inf] * (n + 1)
        back = [None] * (n + 1)
        best[0] = 0.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_len), end):
                lp = self._piece_logp.get(word[start:end])
                if lp is None or best[start] == -math.inf:
                    continue
                if best[start] + lp > best[end]:
                    best[end] = best[start] + lp
                    back[end] = start
        if best[n] == -math.inf:
            # unreachable char in vocab -> per-char with <unk> fallback
            return [ch if ch in self._piece_logp else "<unk>"
                    for ch in word]
        out, pos = [], n
        while pos > 0:
            start = back[pos]
            out.append(word[start:pos])
            pos = start
        return out[::-1]

    def _save_extra(self):
        return {"log_probs": self.log_probs}

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return cls(obj["pieces"], obj["log_probs"], unk_id=obj["unk_id"])


def load_tokenizer(path):
    """Load any saved tokenizer by its recorded model_type."""
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    if obj.get("model_type") == "bpe":
        return BpeTokenizer(obj["pieces"], obj["merges"],
                            unk_id=obj["unk_id"])
    if obj.get("model_type") == "unigram":
        return UnigramTokenizer(obj["pieces"], obj["log_probs"],
                                unk_id=obj["unk_id"])
    return CharTokenizer(obj["pieces"], unk_id=obj["unk_id"])


def train_tokenizer(model_dir, texts, vocab_size, model_type="char",
                    character_coverage=1.0, unk_id=0):
    """Train or load a tokenizer; mirrors the reference wrapper's
    train-on-main/load-elsewhere contract (SentencePiece.py:279-393).

    char -> native ``CharTokenizer``. bpe/unigram -> the SentencePiece
    library if importable (not bundled in this image).
    """
    path = os.path.join(model_dir, f"{model_type}_{vocab_size}.json")
    if model_type == "char":
        if os.path.exists(path):
            return CharTokenizer.load(path)
        tok = CharTokenizer.train(texts, vocab_size=vocab_size,
                                  unk_id=unk_id,
                                  character_coverage=character_coverage)
    elif model_type == "bpe":
        if os.path.exists(path):
            return BpeTokenizer.load(path)
        tok = BpeTokenizer.train(texts, vocab_size=vocab_size, unk_id=unk_id)
    elif model_type == "unigram":
        if os.path.exists(path):
            return UnigramTokenizer.load(path)
        tok = UnigramTokenizer.train(texts, vocab_size=vocab_size,
                                     unk_id=unk_id)
    else:
        raise ValueError(f"Unknown model_type: {model_type!r} "
                         f"(expected char/bpe/unigram)")
    tok.save(path)
    return tok
