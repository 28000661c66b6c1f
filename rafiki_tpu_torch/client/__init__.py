"""Client SDK for the control plane.

Counterpart of ``rafiki_tpu/client``.
"""

from rafiki_tpu_torch.client.client import Client, ClientError

__all__ = ["Client", "ClientError"]
