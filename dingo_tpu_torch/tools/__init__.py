"""Operational tools of the port (the counterparts of the repo's
``tools/``), run with ``python -m dingo_tpu_torch.tools.<name>``."""
