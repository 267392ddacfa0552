"""Persistence of the port: checkpoints, the reference's legacy torch
checkpoints, snapshots, and the weights bridge and fixture files."""

from .checkpoint import CheckpointManager
from .snapshot import load_snapshot, save_snapshot
from .torch_compat import (
    export_legacy_checkpoint,
    flax_to_torch_state_dict,
    import_legacy_checkpoint,
    torch_state_dict_to_flax,
)

__all__ = [
    "CheckpointManager",
    "export_legacy_checkpoint",
    "import_legacy_checkpoint",
    "flax_to_torch_state_dict",
    "torch_state_dict_to_flax",
    "save_snapshot",
    "load_snapshot",
]
