"""Data parallelism over ``torch.distributed``: process-group helpers
(``distributed``), the launcher (``launch``) and the data axis's batch
layout (``mesh``)."""
