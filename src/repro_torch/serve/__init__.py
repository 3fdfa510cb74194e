"""Serving on one device: step bodies, state specs, engine."""
