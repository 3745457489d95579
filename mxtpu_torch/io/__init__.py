"""``mxtpu_torch.io`` (counterpart of ``mxtpu/io/``; the record-file
iterators are not ported)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter, MNISTIter,
                 SimpleIter, create)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter",
           "SimpleIter", "create"]
