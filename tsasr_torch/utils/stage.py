"""Experiment stages (the port's copy of the JAX package's
``utils/stage.py``, the reference's ``speechbrain.Stage``)."""

from enum import Enum, auto


class Stage(Enum):
    """Current stage of an experiment: TRAIN, VALID or TEST."""

    TRAIN = auto()
    VALID = auto()
    TEST = auto()
