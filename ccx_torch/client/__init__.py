"""Python REST client + cccli (ref M4/C38)."""

from ccx_torch.client.client import CruiseControlClient, CruiseControlClientError

__all__ = ["CruiseControlClient", "CruiseControlClientError"]
