"""``mxtpu_torch.optimizer`` (counterpart of ``mxtpu/optimizer/``)."""
from .optimizer import (Optimizer, SGD, Signum, SignSGD, FTML, DCASGD, NAG,
                        SGLD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl,
                        Adamax, Nadam, LBSGD, Test, ScanStep, Updater,
                        get_updater, create, register)

opt = Optimizer
