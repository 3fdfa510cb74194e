"""Runnable examples of the port, counterparts of the JAX package's
``examples/`` scripts: ``python -m repro_torch.examples.<name>``
(quickstart, serve_decode, train_lm).  Each runs on the card unless given
``--device cpu``, and takes size flags so a test can shrink it."""
