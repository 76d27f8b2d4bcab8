"""Synthesize a tiny LibriSpeechMix-shaped dataset for smoke tests.

Generates per-speaker "utterances" (band-limited tone+noise mixtures with
deterministic seeds) plus {split}.jsonl annotation files in the
LibriSpeechMix format, so the full training pipeline can run end-to-end
on hosts without the real corpus (the reference bundles tiny test audio
for the same purpose, ``vendor/speechbrain/tests/samples``).

The port's own copy of the repo's ``tools/make_synthetic_dataset.py``:
the same corpus for the same arguments and seed, written through
``tsasr_torch.data.audio.write_wav``, so a machine with PyTorch alone can
make it. Run it as ``python -m tsasr_torch.tools.make_synthetic_dataset
OUT_DIR --encode_text``.
"""

import argparse
import json
import os

import numpy as np


WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "a", "lazy",
         "dog", "and", "runs", "far", "away", "home", "now"]


CHAR_ALPHABET = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
CHAR_DUR = 0.08          # seconds of audio per character (encode_text mode)
CHAR_F_BASE = 800.0      # char tone band: 800..1840 Hz, disjoint from the
CHAR_F_STEP = 40.0       # speaker-f0 harmonic band (< 750 Hz)


def synth_utterance(rng, duration, sample_rate, f0=None, text=None):
    """A crude 'speech-like' signal: sum of drifting tones + noise.

    ``f0`` fixes the fundamental (the speaker's 'voice') so enrollment
    utterances carry a usable speaker identity for target-speaker
    conditioning; drawn at random per utterance when None.

    ``text`` (encode_text mode): the transcript is acoustically CODED —
    character ``i`` occupies the ``[i*CHAR_DUR, (i+1)*CHAR_DUR)`` slot as
    a pure tone at ``CHAR_F_BASE + CHAR_F_STEP*index(c)``, layered over
    the speaker's harmonic stack. Without this, the waveform carries no
    information about the transcript at all, so WER floors in the 90s no
    matter how long either framework trains; with it the task is a
    learnable toy acoustic code and the cross-framework WER comparison
    operates in the learning regime."""
    n = int(duration * sample_rate)
    t = np.arange(n) / sample_rate
    sig = np.zeros(n, np.float32)
    if f0 is None:
        f0 = rng.uniform(90, 250)
    for harmonic in range(1, 4):
        vibr = 1 + 0.02 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        sig += (0.2 / harmonic) * np.sin(
            2 * np.pi * f0 * harmonic * vibr * t).astype(np.float32)
    if text is None:
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t))
        sig = sig * envelope.astype(np.float32)
    else:
        sig *= 0.4  # keep the speaker-ID stack present but sub-dominant
        cd = int(CHAR_DUR * sample_rate)
        ramp = min(cd // 8, 64)
        env = np.ones(cd, np.float32)
        env[:ramp] = np.linspace(0, 1, ramp, dtype=np.float32)
        env[-ramp:] = np.linspace(1, 0, ramp, dtype=np.float32)
        for i, c in enumerate(text):
            start = i * cd
            if start >= n:
                break
            seg = slice(start, min(start + cd, n))
            k = CHAR_ALPHABET.index(c) if c in CHAR_ALPHABET else 0
            fc = CHAR_F_BASE + CHAR_F_STEP * k
            tone = 0.5 * np.sin(2 * np.pi * fc * t[seg]).astype(np.float32)
            sig[seg] += tone * env[: seg.stop - seg.start]
    sig += rng.normal(0, 0.01, n).astype(np.float32)
    return np.clip(sig, -1, 1)


def make_dataset(out_dir, n_speakers=4, utts_per_speaker=6, n_mix=12,
                 num_speakers_per_mix=2, min_dur=1.0, max_dur=3.0,
                 sample_rate=16000, seed=0, splits=("train-2mix",
                                                    "dev-clean-2mix",
                                                    "test-clean-2mix"),
                 split_n_mix=None, encode_text=False):
    """``n_mix`` mixtures per split, or ``split_n_mix`` ({split: count})
    for asymmetric corpora (e.g. a large train split).

    ``encode_text=True`` makes the waveforms carry their transcripts as
    a per-character tone code (see ``synth_utterance``); the utterance
    duration is then derived from the text length (CHAR_DUR s/char)."""
    from tsasr_torch.data.audio import write_wav
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    # speaker utterance inventory
    inventory = {}
    texts = {}
    for spk in range(n_speakers):
        spk_dir = os.path.join(out_dir, f"spk{spk}")
        os.makedirs(spk_dir, exist_ok=True)
        # a stable per-speaker voice: fixed fundamental, well separated
        spk_f0 = 100.0 + (160.0 / max(n_speakers, 4)) * spk \
            + float(rng.uniform(-5, 5))
        utts = []
        for u in range(utts_per_speaker):
            dur = float(rng.uniform(min_dur, max_dur))
            n_words = max(2, int(dur * 3))
            text = " ".join(rng.choice(WORDS, n_words)).upper()
            if encode_text:
                dur = 0.1 + CHAR_DUR * len(text)
                wav = synth_utterance(rng, dur, sample_rate, f0=spk_f0,
                                      text=text)
            else:
                wav = synth_utterance(rng, dur, sample_rate, f0=spk_f0)
            rel = f"spk{spk}/utt{u}.wav"
            write_wav(os.path.join(out_dir, rel), wav, sample_rate)
            utts.append((rel, dur))
            texts[rel] = text
        inventory[spk] = utts

    for split in splits:
        entries = []
        count = (split_n_mix or {}).get(split, n_mix)
        for m in range(count):
            spks = rng.choice(n_speakers, num_speakers_per_mix,
                              replace=False)
            wavs, durations, delays, mix_texts = [], [], [], []
            for i, spk in enumerate(spks):
                rel, dur = inventory[spk][
                    rng.integers(len(inventory[spk]))]
                wavs.append(rel)
                durations.append(dur)
                delays.append(0.0 if i == 0
                              else float(rng.uniform(0, 1.0)))
                mix_texts.append(texts[rel])
            profile = []
            profile_index = []
            for spk in spks:
                enrolls = [rel for rel, _ in inventory[spk]
                           if rel not in wavs][:2]
                profile_index.append(len(profile))
                profile.append(enrolls or [inventory[spk][0][0]])
            entries.append({
                "id": f"{split}_{m}",
                "wavs": wavs,
                "durations": durations,
                "delays": delays,
                "texts": mix_texts,
                "speaker_profile": profile,
                "speaker_profile_index": profile_index,
                "speakers": [f"spk{s}" for s in spks],
                "genders": ["m" for _ in spks],
            })
        with open(os.path.join(out_dir, f"{split}.jsonl"), "w") as f:
            for entry in entries:
                f.write(json.dumps(entry) + "\n")
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("--n_mix", type=int, default=12)
    parser.add_argument("--train_mix", type=int, default=None,
                        help="mixtures for the train split (others n_mix)")
    parser.add_argument("--n_speakers", type=int, default=4)
    parser.add_argument("--utts_per_speaker", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--encode_text", action="store_true",
                        help="acoustically code transcripts into the "
                             "waveforms (learnable-task mode)")
    args = parser.parse_args()
    split_n_mix = ({"train-2mix": args.train_mix}
                   if args.train_mix is not None else None)
    make_dataset(args.out_dir, n_mix=args.n_mix, seed=args.seed,
                 n_speakers=args.n_speakers,
                 utts_per_speaker=args.utts_per_speaker,
                 split_n_mix=split_n_mix, encode_text=args.encode_text)
    print(f"Synthetic LibriSpeechMix-style dataset at {args.out_dir}")
