"""Process-group helpers. The port runs one process on one card; DDP is
not ported yet."""
