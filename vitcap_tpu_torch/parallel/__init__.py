"""Data and tensor parallelism on torch.distributed: one process a device."""
