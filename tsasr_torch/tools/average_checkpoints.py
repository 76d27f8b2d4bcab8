"""Average the model parameters of the N best checkpoints.

The port's copy of the JAX package's ``tools/average_checkpoints.py``:
the ``"model"`` state dict of the N best ``brain.ckpt`` files on
``--min_key`` is averaged (``training.checkpoints.average_checkpoints``),
and everything else (optimizer, counters) is taken from the best one.
``TSASRTranscriber.from_experiment(..., ckpt_path=...)`` loads the result.

Usage:
    python -m tsasr_torch.tools.average_checkpoints <save_folder> \\
        --num 5 --min_key WER --out averaged.ckpt
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("save_folder",
                        help="checkpoints dir (experiment save/)")
    parser.add_argument("--num", type=int, default=5)
    parser.add_argument("--min_key", default="WER")
    parser.add_argument("--recoverable", default="brain",
                        help="which recoverable file to average")
    parser.add_argument("--out", default="averaged.ckpt")
    args = parser.parse_args(argv)

    from tsasr_torch.training.checkpoints import (Checkpointer,
                                                  average_checkpoints,
                                                  load_state, save_state)

    best = Checkpointer(args.save_folder).find_checkpoints(
        min_key=args.min_key, max_num_checkpoints=args.num)
    if not best:
        raise SystemExit(f"No checkpoints found in {args.save_folder}")
    print(f"Averaging {len(best)} checkpoints "
          f"({[c.meta.get(args.min_key) for c in best]})")
    out = load_state(best[0].paramfile(args.recoverable))
    out["model"] = average_checkpoints(best, args.recoverable)["model"]
    save_state(out, args.out)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
