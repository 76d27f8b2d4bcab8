"""Tools of the port: the synthetic LibriSpeechMix-shaped corpus."""
