"""Parallel training and inference: the process group and its rank layout
(``distributed``), the (dp, fsdp) mesh with FSDP2 sharding (``mesh``), and
sequence-parallel inference (``sp``)."""
