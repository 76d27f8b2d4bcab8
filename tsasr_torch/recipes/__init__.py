"""Recipes: the LibriSpeechMix target-speaker ASR trainer."""

from tsasr_torch.recipes.librispeechmix import TSASRBrain  # noqa: F401
