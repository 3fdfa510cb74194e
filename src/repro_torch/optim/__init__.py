"""AdamW and gradient compression on one device (``repro.optim``)."""
