"""Metric accumulators: per-utterance scores, and error-rate (WER/CER)
stats with Kaldi-style report writing.

The port's own copy of ``MetricStats`` and ``ErrorRateStats`` from the
JAX package's ``utils/metric_stats.py`` (the reference's
``vendor/speechbrain/speechbrain/utils/metric_stats.py``), over the
port's ``utils/edit_distance.py``:
- ``MetricStats`` (:23): per-utterance scores with summarize().
- ``ErrorRateStats`` (:196): accumulates WER details per batch
  (``wer_details_for_batch``), ``summarize("error_rate")`` returns the
  corpus WER, ``write_stats`` emits the Kaldi-style report with
  per-utterance alignments; ``split_tokens=True`` turns it into a CER
  metric (the recipe's cer_computer).
- ``AccuracyStats``: top-1 accuracy over masked targets;
  ``BinaryMetricStats``: scores and 0/1 labels of verification trials,
  summarized as EER, minDCF and the EER threshold (numpy, as in JAX).
"""

import numpy as np

from tsasr_torch.utils import edit_distance as ed


class MetricStats:
    """Generic per-utterance metric accumulation."""

    def __init__(self, metric=None, n_jobs=1):
        self.metric = metric
        self.clear()

    def clear(self):
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, *args, **kwargs):
        scores = self.metric(*args, **kwargs)
        self.ids.extend(ids)
        self.scores.extend(np.asarray(scores).reshape(-1).tolist())

    def summarize(self, field=None):
        arr = np.asarray(self.scores, np.float64)
        self.summary = {
            "average": float(arr.mean()) if arr.size else 0.0,
            "min_score": float(arr.min()) if arr.size else 0.0,
            "min_id": self.ids[int(arr.argmin())] if arr.size else "",
            "max_score": float(arr.max()) if arr.size else 0.0,
            "max_id": self.ids[int(arr.argmax())] if arr.size else "",
        }
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream, verbose=False):
        if not self.summary:
            self.summarize()
        print(f"Average score: {self.summary['average']}", file=filestream)
        print(f"Min error: {self.summary['min_score']} "
              f"id: {self.summary['min_id']}", file=filestream)
        print(f"Max error: {self.summary['max_score']} "
              f"id: {self.summary['max_id']}", file=filestream)


class ErrorRateStats(MetricStats):
    """Word/character error-rate accumulation with alignment reports."""

    def __init__(self, merge_tokens=False, split_tokens=False,
                 space_token="_"):
        self.merge_tokens = merge_tokens
        self.split_tokens = split_tokens
        self.space_token = space_token
        self.clear()

    def clear(self):
        self.scores = []
        self.summary = {}

    def append(self, ids, predict, target, predict_len=None,
               target_len=None, ind2lab=None):
        """Accumulate a batch. predict/target: lists of token lists
        (already decoded to words for WER, or raw tokens)."""
        if predict_len is not None:
            predict = [p[: int(l)] for p, l in zip(predict, predict_len)]
        if target_len is not None:
            target = [t[: int(l)] for t, l in zip(target, target_len)]
        if ind2lab is not None:
            predict = [ind2lab(p) for p in predict]
            target = [ind2lab(t) for t in target]
        if self.merge_tokens:
            predict = ["".join(p).replace(self.space_token, " ").split(" ")
                       for p in predict]
            target = ["".join(t).replace(self.space_token, " ").split(" ")
                      for t in target]
        if self.split_tokens:
            # word lists -> char lists (CER)
            predict = [list("".join(p)) for p in predict]
            target = [list("".join(t)) for t in target]
        self.scores.extend(
            ed.wer_details_for_batch(ids, target, predict,
                                     compute_alignments=True))

    def summarize(self, field=None):
        self.summary = ed.wer_summary(self.scores)
        # reference aliases
        self.summary["error_rate"] = self.summary["WER"]
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        """Kaldi-style report: summary header + per-utterance alignments."""
        if not self.summary:
            self.summarize()
        s = self.summary
        partial = " [PARTIAL]" \
            if s["num_scored_sents"] < s["num_ref_sents"] else ""
        print(f"%WER {s['WER']:.2f} [ {s['num_edits']} / "
              f"{s['num_scored_tokens']}, {s['insertions']} ins, "
              f"{s['deletions']} del, {s['substitutions']} sub ]{partial}",
              file=filestream)
        print(f"%SER {s['SER']:.2f} [ {s['num_erraneous_sents']} / "
              f"{s['num_scored_sents']} ]", file=filestream)
        print(f"Scored {s['num_scored_sents']} sentences, "
              f"{s['num_absent_sents']} not present in hyp.",
              file=filestream)
        print("=" * 80, file=filestream)
        print("ALIGNMENTS", file=filestream)
        print("", file=filestream)
        print("Format:", file=filestream)
        print("<utterance-id>, WER DETAILS", file=filestream)
        print("<eps> ; reference ; on ; the ; first ; line", file=filestream)
        print("  I   ;    =      ; =  ;  =  ;   S   ; line", file=filestream)
        print(" hyp  ; reference ; on ; the ; first ; line", file=filestream)
        for d in self.scores:
            print("=" * 80, file=filestream)
            print(f"{d['key']}, %WER {d['WER']:.2f} [ {d['num_edits']} / "
                  f"{d['num_ref_tokens']}, {d['insertions']} ins, "
                  f"{d['deletions']} del, {d['substitutions']} sub ]",
                  file=filestream)
            _print_alignment(d, filestream)


def _print_alignment(detail, filestream, empty="<eps>", sep=" ; "):
    refs, ops, hyps = [], [], []
    for op, ri, hi in detail["alignment"]:
        ref_tok = detail["ref_tokens"][ri] if ri is not None else empty
        hyp_tok = detail["hyp_tokens"][hi] if hi is not None else empty
        width = max(len(str(ref_tok)), len(str(hyp_tok)), len(op))
        refs.append(str(ref_tok).center(width))
        hyps.append(str(hyp_tok).center(width))
        ops.append(op.center(width))
    print(sep.join(refs), file=filestream)
    print(sep.join(ops), file=filestream)
    print(sep.join(hyps), file=filestream)


class AccuracyStats(MetricStats):
    """Top-1 accuracy over masked targets (reference ``Accuracy``-style)."""

    def __init__(self):
        self.correct = 0
        self.total = 0
        self.summary = {}

    def clear(self):
        self.__init__()

    def append(self, log_probs, targets, lengths=None):
        preds = np.argmax(np.asarray(log_probs), axis=-1)
        targets = np.asarray(targets)
        if lengths is not None:
            mask = (np.arange(targets.shape[1])[None, :]
                    < np.round(np.asarray(lengths)
                               * targets.shape[1])[:, None])
        else:
            mask = np.ones_like(targets, bool)
        self.correct += int(((preds == targets) & mask).sum())
        self.total += int(mask.sum())

    def summarize(self, field=None):
        acc = self.correct / max(self.total, 1)
        self.summary = {"accuracy": acc}
        return acc if field else self.summary


class BinaryMetricStats(MetricStats):
    """Scores+labels accumulation with EER / minDCF summaries
    (reference ``EER``/``minDCF`` helpers, ``metric_stats.py:500-609``)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.ids = []
        self.scores = []
        self.labels = []
        self.summary = {}

    def append(self, ids, scores, labels):
        self.ids.extend(ids)
        self.scores.extend(np.asarray(scores).reshape(-1).tolist())
        self.labels.extend(np.asarray(labels).reshape(-1).tolist())

    def summarize(self, field=None, p_target=0.01, c_miss=1.0, c_fa=1.0):
        scores = np.asarray(self.scores)
        labels = np.asarray(self.labels)
        pos = np.sort(scores[labels == 1])
        neg = np.sort(scores[labels == 0])
        if pos.size == 0 or neg.size == 0:
            self.summary = {"EER": 0.0, "minDCF": 0.0}
        else:
            thresholds = np.unique(np.concatenate([pos, neg]))
            fnr = np.searchsorted(pos, thresholds, "left") / pos.size
            far = 1.0 - np.searchsorted(neg, thresholds, "left") / neg.size
            i = int(np.argmin(np.abs(fnr - far)))
            eer = float((fnr[i] + far[i]) / 2)
            dcf = c_miss * fnr * p_target + c_fa * far * (1 - p_target)
            self.summary = {"EER": eer, "minDCF": float(dcf.min()),
                            "threshold": float(thresholds[i])}
        if field is not None:
            return self.summary[field]
        return self.summary
