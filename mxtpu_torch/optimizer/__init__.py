"""``mxtpu_torch.optimizer`` (counterpart of ``mxtpu/optimizer/``)."""
from .optimizer import (Optimizer, SGD, Adam, ScanStep, Updater,
                        get_updater, create, register)

opt = Optimizer
