"""ARPA-format n-gram model I/O.

Reads/writes the standard ARPA layout (``\\data\\`` header with per-order
counts, ``\\N-grams:`` sections of ``logprob  tokens...  [backoff]``
lines, ``\\end\\``) into the nested-dict layout used by
:class:`tsasr_torch.lm.ngram.BackoffNgramLM`. Reference reader:
``speechbrain/lm/arpa.py:69-229`` (the reference has no writer; KenLM et
al. produce the files — ``write_arpa`` closes the round-trip).

The port's own copy of the JAX package's ``lm/arpa.py``, line for
line, with its imports pointed at ``tsasr_torch``.
"""

import collections


def read_arpa(fstream):
    r"""Parse an ARPA model from a text stream.

    Returns ``(num_ngrams, ngrams_by_order, backoffs_by_order)``:
    ``num_ngrams[n]`` the promised counts from ``\data\``;
    ``ngrams_by_order[n][context][token] -> log10 prob``;
    ``backoffs_by_order[n][context_tuple] -> log10 backoff weight``.
    Raises ValueError on malformed input or missing sections.
    """
    lines = iter(fstream)

    for raw in lines:
        if raw.strip() == "\\data\\":
            break
    else:
        raise ValueError("no \\data\\ section found")

    num_ngrams = {}
    section_order = None
    for raw in lines:
        line = raw.strip()
        if line.startswith("ngram "):
            spec, count = line[len("ngram "):].split("=")
            num_ngrams[int(spec)] = int(count)
        elif _section_order(line) is not None:
            section_order = _section_order(line)
            break
        elif line:
            raise ValueError(f"unexpected line in \\data\\: {line!r}")
    if not num_ngrams:
        raise ValueError("empty \\data\\ section")

    ngrams_by_order = {}
    backoffs_by_order = {}
    ended = False
    while not ended:
        if section_order is None:
            # seek the next section header (or the end marker)
            for raw in lines:
                line = raw.strip()
                if _section_order(line) is not None:
                    section_order = _section_order(line)
                    break
                if line == "\\end\\":
                    ended = True
                    break
                if line:
                    raise ValueError(f"unexpected line: {line!r}")
            else:
                raise ValueError("file ended before \\end\\")
            continue

        order = section_order
        probs = collections.defaultdict(dict)
        backoffs = {}
        section_order = None
        for raw in lines:
            line = raw.strip()
            if not line:
                break
            if _section_order(line) is not None or line == "\\end\\":
                # section ended without a blank separator line
                if line == "\\end\\":
                    ended = True
                else:
                    section_order = _section_order(line)
                break
            parts = line.split()
            logp = float(parts[0])
            if len(parts) == order + 2:
                # trailing backoff weight for the full ngram-as-context
                backoffs[tuple(parts[1:-1])] = float(parts[-1])
                context, token = tuple(parts[1:-2]), parts[-2]
            elif len(parts) == order + 1:
                context, token = tuple(parts[1:-1]), parts[-1]
            else:
                raise ValueError(f"bad {order}-gram line: {line!r}")
            probs[context][token] = logp
        ngrams_by_order[order] = dict(probs)
        backoffs_by_order[order] = backoffs

    if set(num_ngrams) != set(ngrams_by_order):
        raise ValueError(
            f"\\data\\ promises orders {sorted(num_ngrams)} but found "
            f"{sorted(ngrams_by_order)}")
    return num_ngrams, ngrams_by_order, backoffs_by_order


def write_arpa(fstream, ngrams_by_order, backoffs_by_order=None):
    """Serialize nested-dict n-grams (log10) to ARPA format.

    Backoff weights are emitted as the optional trailing column on the
    line of the n-gram that equals the backoff context; contexts that
    have a backoff weight but no stored probability get an explicit
    ``-99`` prob line (the conventional ARPA placeholder, e.g. for
    ``<s>``).
    """
    backoffs_by_order = backoffs_by_order or {}

    # flatten: order -> {full_gram_tuple: logprob}
    flat = {}
    for n, ctxs in sorted(ngrams_by_order.items()):
        grams = {}
        for ctx, dist in ctxs.items():
            for tok, lp in dist.items():
                grams[tuple(ctx) + (tok,)] = lp
        flat[n] = grams
    # backoff contexts of order n attach to order-n gram lines
    for n, bo in backoffs_by_order.items():
        if not bo:
            continue
        grams = flat.setdefault(n, {})
        for ctx in bo:
            grams.setdefault(tuple(ctx), -99.0)

    print("\\data\\", file=fstream)
    for n in sorted(flat):
        print(f"ngram {n}={len(flat[n])}", file=fstream)
    for n in sorted(flat):
        print(file=fstream)
        print(f"\\{n}-grams:", file=fstream)
        bo = backoffs_by_order.get(n, {})
        for gram in sorted(flat[n]):
            lp = flat[n][gram]
            line = f"{lp:.6f}\t{' '.join(gram)}"
            if gram in bo:
                line += f"\t{bo[gram]:.6f}"
            print(line, file=fstream)
    print(file=fstream)
    print("\\end\\", file=fstream)


def _section_order(line):
    r"""``\N-grams:`` -> N, else None."""
    if line.startswith("\\") and line.endswith("-grams:"):
        try:
            return int(line[1:].split("-")[0])
        except ValueError:
            return None
    return None
