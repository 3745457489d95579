"""``mxtpu_torch.gluon``: the imperative and hybrid high-level API
(counterpart of ``mxtpu/gluon/``): Parameter, Block, HybridBlock (which
``hybridize()`` runs as one CachedOp), SymbolBlock, Trainer, ``nn``,
``loss``, ``utils``, the model ``zoo``, the fused recurrent layers and
cells of ``rnn``, the datasets, samplers, DataLoader and vision
transforms of ``data``, and the experimental layers, cells and sampler
of ``contrib``."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from . import model_zoo
from . import rnn
from . import data
from . import contrib
