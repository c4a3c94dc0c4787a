"""Data parallelism on torch.distributed: one process a device."""
