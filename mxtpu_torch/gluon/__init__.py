"""``mxtpu_torch.gluon``: the imperative and hybrid high-level API
(counterpart of ``mxtpu/gluon/``): Parameter, Block, HybridBlock (which
``hybridize()`` runs as one CachedOp), SymbolBlock, Trainer, ``nn``,
``loss``, ``utils``, the ResNets of ``model_zoo`` and the fused
recurrent layers and cells of ``rnn``.  ``data`` and ``contrib`` are
not ported (ROADMAP A13)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from . import model_zoo
from . import rnn
