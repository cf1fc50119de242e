"""Command-line tools of zktpu_torch (run with ``python -m zktpu_torch.tools.<name>``)."""
