"""gluon.data: datasets, samplers and the DataLoader (counterpart of
``mxnet_tpu/gluon/data/``)."""
from . import vision
from .dataloader import DataLoader
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, FilterSampler, RandomSampler, Sampler,
                      SequentialSampler)

__all__ = ["ArrayDataset", "BatchSampler", "DataLoader", "Dataset",
           "FilterSampler", "RandomSampler", "RecordFileDataset", "Sampler",
           "SequentialSampler", "SimpleDataset", "vision"]
