"""Train a backoff n-gram LM on manifest transcripts and write ARPA.

The port's copy of the JAX package's ``tools/train_ngram_lm.py``. The
output ``.arpa`` plugs into decoding via ``--lm_path lm.arpa --lm_weight
0.3`` (the recipe's ``_load_fusion_lm`` densifies it for the beams).

Usage:
  python -m tsasr_torch.tools.train_ngram_lm --data_folder /tmp/data \\
      --tokenizer results/.../save/char_28.json --order 3 --out lm.arpa
"""

import argparse
import json
import os


def load_texts(data_folder):
    texts = []
    for name in sorted(os.listdir(data_folder)):
        if name.endswith(".jsonl"):
            with open(os.path.join(data_folder, name)) as f:
                for line in f:
                    entry = json.loads(line)
                    texts.extend(entry.get("texts", []))
        elif name.endswith(".json"):
            with open(os.path.join(data_folder, name)) as f:
                data = json.load(f)
            if isinstance(data, dict):
                texts.extend(e["wrd"] for e in data.values()
                             if isinstance(e, dict) and "wrd" in e)
    return texts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_folder", required=True,
                    help="folder with LibriSpeechMix jsonl/json manifests")
    ap.add_argument("--tokenizer", required=True,
                    help="the experiment's tokenizer file (save/<type>_"
                         "<vocab>.json); its pieces are the LM vocabulary")
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--discount", type=float, default=0.5)
    ap.add_argument("--out", required=True, help="output .arpa path")
    args = ap.parse_args(argv)

    from tsasr_torch.data.tokenizer import load_tokenizer
    from tsasr_torch.lm import (
        BackoffNgramLM,
        ngram_evaluation_details,
        ngram_perplexity,
        ngrams_for_evaluation,
        pad_ends,
        train_backoff_ngram,
        write_arpa,
    )

    tokenizer = load_tokenizer(args.tokenizer)
    texts = load_texts(args.data_folder)
    if not texts:
        raise SystemExit(f"no transcripts found in {args.data_folder}")
    # token-piece sentences so the ARPA vocabulary == tokenizer pieces
    sents = [tokenizer.encode_as_pieces(t) for t in texts]
    ngrams_d, backoffs = train_backoff_ngram(
        sents, order=args.order, discount=args.discount)
    with open(args.out, "w") as f:
        write_arpa(f, ngrams_d, backoffs)

    lm = BackoffNgramLM(ngrams_d, backoffs)
    data = [list(ngrams_for_evaluation(pad_ends(s), args.order))
            for s in sents[:500]]
    ppl = ngram_perplexity(ngram_evaluation_details(data, lm))
    print(json.dumps({"arpa": args.out, "order": args.order,
                      "sentences": len(sents),
                      "train_perplexity": round(ppl, 3)}))


if __name__ == "__main__":
    main()
