"""Control plane: admin business logic, services manager, REST app.

Counterpart of ``rafiki_tpu/admin``: ``Admin`` holds the business
logic, ``ServicesManager`` turns jobs into in-host threads on the
card, and ``app.py`` serves the REST API.
"""

from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.services_manager import ServicesManager

__all__ = ["Admin", "ServicesManager"]
