"""The training step on one device (``repro.train``)."""
