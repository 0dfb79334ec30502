"""Measurement tools of the port, run as modules
(``python -m lmcache_tpu_torch.tools.<name>``)."""
