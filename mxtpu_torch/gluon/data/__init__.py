"""``mxtpu_torch.gluon.data`` (counterpart of ``mxtpu/gluon/data/``):
datasets, samplers, the DataLoader and the vision datasets and
transforms.  ``RecordFileDataset`` waits for ``recordio`` (ROADMAP
A16)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision
