"""``mxtpu_torch.io`` (counterpart of ``mxtpu/io/``)."""
from .io import DataDesc, DataBatch, DataIter, NDArrayIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]
