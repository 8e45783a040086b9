# Copy of src/repro/serve/errors.py (no jax); docstrings name repro_torch.
"""Exception types raised by the exploration service."""
from __future__ import annotations

__all__ = ["QueueFull", "RequestTimeout", "ServeError", "ServiceClosed"]


class ServeError(RuntimeError):
    """Base class for serving failures."""


class ServiceClosed(ServeError):
    """The service is shut down (or shutting down) and not accepting —
    or no longer able to complete — requests."""


class QueueFull(ServeError):
    """The bounded request queue is at capacity; the submit was refused
    (backpressure — retry later or raise ``max_queue``)."""


class RequestTimeout(ServeError):
    """The request's deadline expired before the service completed it
    (in the queue, or between dispatch segments)."""
