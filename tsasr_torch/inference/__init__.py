"""Inference interfaces: transcription (offline and streaming), speaker
verification and audio classification."""

from tsasr_torch.inference.transcriber import TSASRTranscriber  # noqa: F401
from tsasr_torch.inference.streaming import StreamingTranscriber  # noqa: F401
from tsasr_torch.inference.speaker import SpeakerRecognition  # noqa: F401
from tsasr_torch.inference.classifier import EncoderClassifier  # noqa: F401
