"""Parallel training: the process group and its rank layout
(``distributed``), and the (dp, fsdp) mesh with FSDP2 sharding (``mesh``)."""
