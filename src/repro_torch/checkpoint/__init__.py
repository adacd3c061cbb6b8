from repro_torch.checkpoint.ckpt import save_pytree, restore_pytree, latest_step  # noqa: F401
