"""The deterministic data pipeline (``repro.data``, copied)."""
