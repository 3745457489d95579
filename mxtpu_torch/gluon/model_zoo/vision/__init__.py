"""``mxtpu_torch.gluon.model_zoo.vision`` (counterpart of
``mxtpu/gluon/model_zoo/vision/``): the ResNets and ``get_model``.  The
other families (AlexNet, DenseNet, Inception, MobileNet, SqueezeNet,
VGG) wait (ROADMAP A13)."""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

from ....base import MXNetError

_models = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name.startswith("resnet")}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise MXNetError("model %r not in the model zoo (%s)"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
