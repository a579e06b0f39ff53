"""Framework exceptions (counterpart of ``torchmetrics_tpu/utilities/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised when a user misuses the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on suspicious-but-legal metric API usage."""
