"""repro_torch.checkpoint — atomic step-directory save / restore-latest."""
from .ckpt import latest_step, restore, restore_latest, save

__all__ = ["save", "restore", "restore_latest", "latest_step"]
