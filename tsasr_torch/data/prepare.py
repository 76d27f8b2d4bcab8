"""LibriSpeechMix manifest preparation.

The port's own copy of the JAX package's ``data/prepare.py``, line for
line, with its imports pointed at ``tsasr_torch``.

Re-implements the semantics of the reference's dataset prep
(the reference's ``librispeechmix_prepare.py:35-229``): expand each
LibriSpeechMix JSONL entry (wavs, delays, durations, speaker_profile,
texts) into one manifest entry per (target speaker, enrollment utterance)
pair, supporting:

- ``num_targets``: int (first N), list (explicit indices), "min"/"max"
  (shortest/longest utterance only), or None (all);
- ``num_enrolls``: cap on enrollment utterances per target;
- ``trim_nontarget``: crop window of at most this many seconds around the
  target utterance (0 = exactly the target's span);
- ``suppress_delay``: zero all delays (maximal overlap);
- ``overlap_ratio``: synthesize delays so interferers overlap the target
  by the given ratio (target delay forced to 0).

Splits sharing a prefix (train/dev/test) merge into one ``<group>.json``
keyed by ``"{mixture_id}_text-{target_idx}_{enroll_wav}"``; wav paths are
prefixed with the ``{DATA_ROOT}`` placeholder for later substitution.
"""

import json
import os
from collections import defaultdict

DEFAULT_SPLITS = (
    "dev-clean-1mix", "dev-clean-2mix", "dev-clean-3mix",
    "test-clean-1mix", "test-clean-2mix", "test-clean-3mix",
)


def _target_indices(num_targets, durations, num_texts):
    if isinstance(num_targets, (int, float)):
        return list(range(int(num_targets)))
    if isinstance(num_targets, (list, tuple)):
        return list(num_targets)
    if num_targets == "min":
        return [int(min(range(len(durations)), key=durations.__getitem__))]
    if num_targets == "max":
        return [int(max(range(len(durations)), key=durations.__getitem__))]
    if num_targets is None:
        return list(range(num_texts))
    raise NotImplementedError(f"num_targets={num_targets!r}")


def _crop_window(delays, durations, target_idx, trim_nontarget):
    """(start, duration) of the mixture segment to keep."""
    full_duration = max(d + x for d, x in zip(delays, durations))
    if trim_nontarget is None:
        return 0.0, full_duration
    target_start = delays[target_idx]
    target_dur = durations[target_idx]
    start = max(0.0, target_start - trim_nontarget)
    duration = target_dur + (target_start - start)
    duration = min(duration + trim_nontarget, full_duration - start)
    return start, duration


def prepare_librispeechmix(data_folder, save_folder=None,
                           splits=DEFAULT_SPLITS, num_targets=None,
                           num_enrolls=None, trim_nontarget=None,
                           suppress_delay=None, overlap_ratio=None):
    """Write ``<group>.json`` manifests into ``save_folder``."""
    save_folder = save_folder or data_folder
    if not splits:
        raise ValueError("`splits` must be non-empty")
    if suppress_delay is not None and overlap_ratio is not None:
        raise ValueError(
            "set either `suppress_delay` or `overlap_ratio`, not both")
    if overlap_ratio is not None and not 0.0 <= overlap_ratio <= 1.0:
        raise ValueError(f"overlap_ratio={overlap_ratio} not in [0, 1]")

    groups = defaultdict(list)
    for split in splits:
        prefix = split.split("-")[0]
        if prefix not in ("train", "dev", "test"):
            raise ValueError(
                f"split '{split}' must start with train/dev/test")
        groups[prefix].append(split)

    os.makedirs(save_folder, exist_ok=True)
    for group_name, group_splits in groups.items():
        entries = {}
        for split in group_splits:
            jsonl = os.path.join(data_folder, f"{split}.jsonl")
            if not os.path.exists(jsonl):
                raise RuntimeError(f"Annotation file not found: {jsonl}")
            with open(jsonl, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        entries.update(_expand_mixture(
                            json.loads(line), num_targets, num_enrolls,
                            trim_nontarget, suppress_delay, overlap_ratio))
        out_path = os.path.join(save_folder, f"{group_name}.json")
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(entries, f, ensure_ascii=False, indent=4)


def _expand_mixture(mix, num_targets, num_enrolls, trim_nontarget,
                    suppress_delay, overlap_ratio):
    """One JSONL mixture record -> {entry_id: manifest entry}."""
    durations = list(mix["durations"])
    wavs = [os.path.join("{DATA_ROOT}", w) for w in mix["wavs"]]
    out = {}
    for tgt in _target_indices(num_targets, durations, len(mix["texts"])):
        delays = list(mix["delays"])
        if suppress_delay:
            delays = [0.0] * len(delays)
        if overlap_ratio is not None:
            overlap_start = (1 - overlap_ratio) * durations[tgt]
            delays = [overlap_start] * len(delays)
            delays[tgt] = 0.0
        start, duration = _crop_window(delays, durations, tgt,
                                       trim_nontarget)
        profile_idx = mix["speaker_profile_index"][tgt]
        enroll_wavs = mix["speaker_profile"][profile_idx][:num_enrolls]
        for enroll_wav in enroll_wavs:
            entry_id = f"{mix['id']}_text-{tgt}_{enroll_wav}"
            out[entry_id] = {
                "wavs": wavs,
                "enroll_wav": os.path.join("{DATA_ROOT}", enroll_wav),
                "delays": delays,
                "start": start,
                "duration": duration,
                "durations": durations,
                "target_speaker_idx": tgt,
                "wrd": mix["texts"][tgt],
                "speakers": mix.get("speakers"),
                "genders": mix.get("genders"),
            }
    return out
