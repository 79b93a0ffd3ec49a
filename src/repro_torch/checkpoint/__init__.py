from .ckpt import async_save, latest_step, list_steps, restore, save

__all__ = ["save", "async_save", "restore", "latest_step", "list_steps"]
