"""Speaker-verification evaluation over a trial list.

The port's copy of the JAX package's ``tools/eval_speaker_verification.py``,
with ``--device`` (default ``cuda``; ``cpu`` on a host without a card).
Scores (enrol, test) audio pairs with a speaker-embedding backend
(``inference.SpeakerRecognition``), one embedding per file, and prints
one JSON line with the number of trials, the EER and the minDCF
(``utils.metric_stats.BinaryMetricStats``); ``--out`` writes the scores
file, one ``<label> <enrol> <test> <score>`` line per trial.

Trial list format (one per line): ``<label 0|1> <enrol_path> <test_path>``

Backends:

- ``wavlm``: a local HF WavLM x-vector checkpoint directory, the same
  directory the JAX tool reads;
- ``ecapa``: the port's ECAPA file, ``torch.save`` of ``{"config": the
  ECAPAConfig keywords, "state_dict": ...}``. The JAX tool reads a flax
  msgpack file instead, which the port cannot read (it has no flax):
  ``tsasr_torch.convert.save_ecapa_from_flax(payload, path)`` writes the
  port's file from that payload's tree once it is restored to numpy.

Usage:
    python -m tsasr_torch.tools.eval_speaker_verification --trials t.txt \\
        --backend wavlm --model_path /path/to/wavlm_sv_ckpt [--device cpu]
    python -m tsasr_torch.tools.eval_speaker_verification --trials t.txt \\
        --backend ecapa --model_path ecapa.pt [--n_mels 80] [--out s.txt]
"""

import argparse
import json


def load_ecapa(path, n_mels):
    """The port's ECAPA file -> an ``ECAPA_TDNN`` with its weights (on the
    CPU)."""
    import torch
    from tsasr_torch.models.ecapa import ECAPA_TDNN, ECAPAConfig
    payload = torch.load(path, map_location="cpu", weights_only=True)
    config = ECAPAConfig(input_size=n_mels, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in payload.get("config", {}).items()})
    model = ECAPA_TDNN(config)
    model.load_state_dict(payload["state_dict"])
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", required=True)
    ap.add_argument("--backend", choices=["wavlm", "ecapa"],
                    default="wavlm")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--n_mels", type=int, default=80)
    ap.add_argument("--out", default=None, help="scores file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tsasr_torch.inference import SpeakerRecognition
    from tsasr_torch.utils.metric_stats import BinaryMetricStats

    if args.backend == "wavlm":
        sr = SpeakerRecognition.from_wavlm(args.model_path,
                                           sample_rate=args.sample_rate,
                                           device=args.device)
    else:
        from tsasr_torch.device import resolve_device
        from tsasr_torch.ops.features import Fbank
        device = resolve_device(args.device)
        fbank = Fbank(sample_rate=args.sample_rate, n_fft=512,
                      n_mels=args.n_mels, win_length=32.0).to(device)
        sr = SpeakerRecognition.from_ecapa(
            load_ecapa(args.model_path, args.n_mels).to(device), fbank,
            sample_rate=args.sample_rate, device=device)

    stats = BinaryMetricStats()
    cache = {}

    def embed(path):
        if path not in cache:
            cache[path] = sr.encode_file(path)
        return cache[path]

    scores_out = []
    with open(args.trials) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if len(parts) != 3:
                continue
            label, enrol, test = int(parts[0]), parts[1], parts[2]
            score = float(SpeakerRecognition.cosine(embed(enrol),
                                                    embed(test)))
            stats.append([f"trial{i}"], [score], [label])
            scores_out.append((label, enrol, test, score))

    summary = stats.summarize()
    if args.out:
        with open(args.out, "w") as f:
            for label, enrol, test, score in scores_out:
                f.write(f"{label} {enrol} {test} {score:.6f}\n")
    print(json.dumps({"trials": len(scores_out),
                      "EER": round(float(summary["EER"]), 5),
                      "minDCF": round(float(summary["minDCF"]), 5)}))


if __name__ == "__main__":
    main()
