"""Training logger: one stats line per epoch.

The port's own copy of ``FileTrainLogger`` from the JAX package's
``utils/train_logger.py`` (the reference's ``utils/train_logger.py``
:47-105): ``"epoch: N, lr: 1.00e-03 - train loss: y - valid loss: z,
valid WER: w"``, floats in (1, 100) at fixed precision and scientific
notation otherwise. In a launched run only process 0 appends (the
stats it is given are already merged across processes). Its
TensorBoard, W&B and sample loggers are not ported.
"""

import logging
import os

from tsasr_torch.parallel.distributed import if_main_process

logger = logging.getLogger(__name__)


class FileTrainLogger:
    """One summary line per epoch appended to ``save_file``."""

    def __init__(self, save_file, precision=2):
        self.save_file = save_file
        self.precision = precision

    def _format_value(self, value):
        if isinstance(value, float) and 1.0 < value < 100.0:
            return f"{value:.{self.precision}f}"
        if isinstance(value, float):
            return f"{value:.{self.precision}e}"
        return str(value)

    def _stats_to_string(self, stats, dataset=None):
        parts = []
        for key, value in stats.items():
            name = f"{dataset} {key}" if dataset else key
            parts.append(f"{name}: {self._format_value(value)}")
        return ", ".join(parts)

    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=True):
        if not if_main_process():
            return
        summary = self._stats_to_string(stats_meta)
        for dataset, stats in [("train", train_stats),
                               ("valid", valid_stats),
                               ("test", test_stats)]:
            if stats is not None:
                summary += " - " + self._stats_to_string(stats, dataset)
        os.makedirs(os.path.dirname(self.save_file) or ".", exist_ok=True)
        with open(self.save_file, "a") as f:
            print(summary, file=f)
        if verbose:
            logger.info(summary)
