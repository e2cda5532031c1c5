"""MoGe-2 model of the port: DINOv2 encoder, conv neck and heads, and the
``MoGeModel`` inference wrapper."""
