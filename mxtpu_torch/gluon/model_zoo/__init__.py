"""``mxtpu_torch.gluon.model_zoo`` (counterpart of
``mxtpu/gluon/model_zoo/``)."""
from . import vision
from .vision import get_model
