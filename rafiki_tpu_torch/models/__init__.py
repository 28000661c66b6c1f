"""Model zoo: the templates ported so far.

Counterpart of ``rafiki_tpu/models``. ``Vgg`` is in ``models/vgg.py``
(the reference, too, exports only ``FeedForward`` here); the rest of
the zoo, its ``MODEL_REGISTRY`` and ``get_model_class`` wait for
ROADMAP Queue 1 item 11.
"""

from rafiki_tpu_torch.models.ff import FeedForward

__all__ = ["FeedForward"]
