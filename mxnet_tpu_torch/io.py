"""Data iterators (mxnet_tpu/io.py): DataDesc, DataBatch, DataIter and
NDArrayIter over in-memory arrays with pad / discard / roll_over
last-batch handling. Batches are host NDArrays; the executor group
copies them into its device arrays. An unseeded shuffle draws through
`random.np_rng()` (under `mx.random.seed`); the seeded, epoch-keyed
shuffle and the file readers (MNISTIter, CSVIter, PrefetchingIter,
ResizeIter) wait for a later slice.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .ndarray import NDArray, array
from .random import np_rng


class DataDesc:
    """Name+shape(+dtype+layout) descriptor."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.layout = layout

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    def __iter__(self):
        return iter((self.name, self.shape))

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __len__(self):
        return 2

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize data/label input to a sorted list of (name, numpy)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {k: v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
           for k, v in data.items()}
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory numpy/NDArray data: optional one-shot
    shuffle, pad / discard / roll_over for the last batch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        if seed is not None:
            raise MXNetError("NDArrayIter(seed=...) (the epoch-keyed "
                             "shuffle) is not ported yet")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.shuffle = bool(shuffle)
        n = self.data[0][1].shape[0]
        trim = n - n % batch_size if last_batch_handle == "discard" else n
        self.idx = np.arange(n)
        if self.shuffle:
            np_rng().shuffle(self.idx)
        self.idx = self.idx[:trim]
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def reset(self):
        if (self.last_batch_handle == "roll_over"
                and self.cursor > self.num_data):
            self.cursor = -self.batch_size + (
                self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            rows = self.idx[self.cursor: self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            rows = np.concatenate((self.idx[self.cursor:], self.idx[:pad]))
        return [array(x[1][rows]) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0
