"""Diagnostics of the port (counterpart of part of ``torchmetrics_tpu/diag/``).

``costs.state_footprint`` only: the bytes a metric's or a collection's states hold.
The rest of the JAX package's ``diag/`` (traces, histograms, the sentinel, telemetry,
profiles, the transfer guard) has no counterpart yet.
"""
