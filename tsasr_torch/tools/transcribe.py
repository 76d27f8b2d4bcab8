"""Transcribe audio files with a trained experiment.

The port's copy of the JAX package's ``tools/transcribe.py``, with
``--device`` (default ``cuda``; ``cpu`` on a host without a card). One
JSON line per file. ``--streaming`` feeds each file in 1 s chunks to
the ``kv_cache`` streamer (causal models); a model with a speaker input
(a ``scratch`` or a ``pretrained`` experiment) then needs ``--enroll``,
whose embedding (the speaker branch's, or the frozen WavLM's, projected)
conditions the stream (the JAX tool streams without it). A run trained
with ``--precision bf16`` is served in bf16.

Usage:
    python -m tsasr_torch.tools.transcribe --experiment results/.../0 \\
        mix1.wav [mix2.flac ...] [--enroll enroll.wav] [--beam_size 15] \\
        [--lm_path lm.arpa --lm_weight 0.3] [--streaming] [--device cpu]
"""

import argparse
import json

from tsasr_torch.data.audio import read_resampled


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("audio", nargs="+", help="wav/flac files")
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--enroll", default=None,
                    help="enrollment wav (target-speaker variants)")
    ap.add_argument("--beam_size", type=int, default=1)
    ap.add_argument("--lm_path", default=None)
    ap.add_argument("--lm_weight", type=float, default=None)
    ap.add_argument("--streaming", action="store_true",
                    help="chunked streaming decode (causal models)")
    ap.add_argument("--min_key", default="WER")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tsasr_torch.inference import TSASRTranscriber

    t = TSASRTranscriber.from_experiment(
        args.experiment, beam_size=args.beam_size, min_key=args.min_key,
        lm_path=args.lm_path, lm_weight=args.lm_weight, device=args.device)
    speaker = None
    if args.streaming and args.enroll and t.variant != "none":
        speaker = t.speaker_embedding(read_resampled(args.enroll,
                                                     t.sample_rate))
    for path in args.audio:
        if args.streaming:
            wav = read_resampled(path, t.sample_rate)
            s = t.streaming(speaker_embs=speaker)
            chunk = t.sample_rate                     # 1 s chunks
            for lo in range(0, len(wav), chunk):
                s.accept_chunk(wav[lo: lo + chunk])
            text = s.finalize()
        else:
            text = t.transcribe_file(path, enroll_path=args.enroll)
        print(json.dumps({"file": path, "text": text}))


if __name__ == "__main__":
    main()
