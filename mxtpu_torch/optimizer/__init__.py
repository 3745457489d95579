"""``mxtpu_torch.optimizer`` (counterpart of ``mxtpu/optimizer/``)."""
from .optimizer import (Optimizer, SGD, Updater, get_updater, create,
                        register)

opt = Optimizer
