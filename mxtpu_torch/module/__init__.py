"""``mxtpu_torch.mod``: the symbolic Module API on one device
(counterpart of ``mxtpu/module/``): Module and BucketingModule."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule",
           "DataParallelExecutorGroup"]
