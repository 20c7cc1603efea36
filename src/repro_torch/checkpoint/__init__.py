from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
    train_state_from_tree,
    train_state_tree,
)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint", "latest_step",
           "train_state_tree", "train_state_from_tree"]
