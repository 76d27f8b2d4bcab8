"""Small utilities: experiment stages, WER accounting and the precision
softmaxes run in."""
