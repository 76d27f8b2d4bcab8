"""Edit distance and WER accounting.

The port's own copy of the JAX package's ``utils/edit_distance.py``
without its native C++ path: per-utterance alignment with insertion,
deletion and substitution counts, and a corpus summary with
WER = 100 * (S + D + I) / number of reference tokens.

Alignments are lists of (op, ref_index, hyp_index) with op in
{"=", "S", "I", "D"} (index None on the missing side), produced by a
single-pass Levenshtein DP with backtrace.
"""

def edit_ops(ref, hyp):
    """Levenshtein alignment: list of (op, ref_idx, hyp_idx)."""
    n, m = len(ref), len(hyp)
    # DP table of costs, and backtrace of ops
    cost = [[0] * (m + 1) for _ in range(n + 1)]
    back = [[None] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        cost[i][0] = i
        back[i][0] = "D"
    for j in range(1, m + 1):
        cost[0][j] = j
        back[0][j] = "I"
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cost[i][j] = cost[i - 1][j - 1]
                back[i][j] = "="
            else:
                sub = cost[i - 1][j - 1]
                dele = cost[i - 1][j]
                ins = cost[i][j - 1]
                best = min(sub, dele, ins)
                cost[i][j] = best + 1
                back[i][j] = "S" if best == sub else \
                    ("D" if best == dele else "I")
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        op = back[i][j]
        if op in ("=", "S"):
            ops.append((op, i - 1, j - 1))
            i, j = i - 1, j - 1
        elif op == "D":
            ops.append((op, i - 1, None))
            i -= 1
        else:
            ops.append((op, None, j - 1))
            j -= 1
    ops.reverse()
    return ops


def count_ops(ops):
    counts = {"=": 0, "S": 0, "I": 0, "D": 0}
    for op, _, _ in ops:
        counts[op] += 1
    return counts


def wer_details_for_batch(ids, refs, hyps, compute_alignments=True):
    """Per-utterance WER details (list of dicts), reference-compatible keys:
    key, WER, num_edits, num_ref_tokens, insertions/deletions/substitutions,
    ref_tokens, hyp_tokens, alignment."""
    details = []
    for key, ref, hyp in zip(ids, refs, hyps):
        ops = edit_ops(ref, hyp)
        counts = count_ops(ops)
        num_edits = counts["S"] + counts["I"] + counts["D"]
        n_ref = max(len(ref), 1)
        details.append({
            "key": key,
            "scored": True,
            "hyp_absent": hyp is None,
            "num_ref_tokens": len(ref),
            "num_hyp_tokens": len(hyp),
            "num_edits": num_edits,
            "insertions": counts["I"],
            "deletions": counts["D"],
            "substitutions": counts["S"],
            "hits": counts["="],
            "WER": 100.0 * num_edits / n_ref,
            "ref_tokens": list(ref),
            "hyp_tokens": list(hyp),
            "alignment": ops if compute_alignments else None,
        })
    return details


def wer_summary(details):
    """Corpus-level summary over per-utterance details."""
    num_ref_tokens = sum(d["num_ref_tokens"] for d in details)
    ins = sum(d["insertions"] for d in details)
    dels = sum(d["deletions"] for d in details)
    subs = sum(d["substitutions"] for d in details)
    num_edits = ins + dels + subs
    num_scored = len(details)
    erroneous = sum(1 for d in details if d["num_edits"] > 0)
    return {
        "WER": 100.0 * num_edits / max(num_ref_tokens, 1),
        "SER": 100.0 * erroneous / max(num_scored, 1),
        "num_edits": num_edits,
        "num_scored_tokens": num_ref_tokens,
        "insertions": ins,
        "deletions": dels,
        "substitutions": subs,
        "num_scored_sents": num_scored,
        "num_ref_sents": num_scored,
        "num_erraneous_sents": erroneous,
        "num_absent_sents": sum(1 for d in details if d["hyp_absent"]),
    }
