"""Measurement probes of the port: small runnable modules (``python -m``)
that time one kernel on the card beside its yardstick."""
