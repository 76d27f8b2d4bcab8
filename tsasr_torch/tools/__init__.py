"""Tools of the port: the synthetic LibriSpeechMix-shaped corpus,
transcription, checkpoint averaging and n-gram LM training."""
