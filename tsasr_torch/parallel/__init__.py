"""Parallelism over ``torch.distributed``: process-group helpers and the
rank layout over the mesh's axes (``distributed``), the launcher
(``launch``), the batch layout and rank coordinates (``mesh``), the
activation hops between ranks (``hop``), and the encoder split over the
sequence axis (``seq_parallel``) or the pipeline axis
(``pp_parallel``)."""
