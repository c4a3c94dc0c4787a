"""The port's command-line tools: python -m vitcap_tpu_torch.tools.<name>."""
