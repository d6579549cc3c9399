"""Framework exceptions (ref: com.linkedin.kafka.cruisecontrol.exception)."""

from __future__ import annotations


class CruiseControlException(Exception):
    """Root (ref KafkaCruiseControlException)."""


class NotEnoughValidWindowsException(CruiseControlException):
    """Monitor completeness below the request's requirements (ref C8)."""


class OptimizationFailureException(CruiseControlException):
    """A hard goal cannot be satisfied (ref C16)."""


class OngoingExecutionException(CruiseControlException):
    """An execution is already in progress (ref Executor reservation)."""


class UserRequestException(CruiseControlException):
    """Bad request parameters (servlet 400s, ref C32)."""
