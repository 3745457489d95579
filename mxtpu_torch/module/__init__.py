"""``mxtpu_torch.mod``: the symbolic Module API on one device
(counterpart of ``mxtpu/module/``; ``BucketingModule`` is not ported)."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
