"""Models of the port: MoGe-1 (``v1``) and MoGe-2 (``v2``), their DINOv2
encoder and conv decoders, and checkpoint loading."""

from typing import Type


def import_model_class_by_version(version: str) -> Type:
    """The ``MoGeModel`` wrapper class of a model version, 'v1' or 'v2'."""
    if version == "v1":
        from .v1 import MoGeModel
    elif version == "v2":
        from .v2 import MoGeModel
    else:
        raise ValueError(f"Unsupported model version: {version}")
    return MoGeModel
