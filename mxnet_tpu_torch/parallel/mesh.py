"""Device meshes (mxnet_tpu/parallel/mesh.py).

The JAX package has one controller: one process drives a
jax.sharding.Mesh over devices, and across hosts the processes join one
global mesh. PyTorch has no single controller, so the port's `Mesh` is a
grid of (process, Context) entries with axis names, and what a mesh
means depends on where its entries live:

- In one process its entries are Contexts of this process. Module and
  the fused step compute over such a mesh what GSPMD computes over it,
  on the mesh's one torch device: the step over the global batch
  (gradients summed over every axis the batch is split over, BatchNorm's
  statistics over the global batch), parameters whole. Every context of
  such a mesh is the same torch device, which is always so on the host
  (`cpu(i)` names the one host device). The specs are still resolved
  and recorded, and mesh-aware ops read the ambient mesh (`use_mesh`):
  ring attention runs its shards' steps one after another on the
  device. Distinct CUDA cards in one process are refused where a mesh
  is used: one process a card, under tools/launch.py.
- Across processes (tools/launch.py) each process is one entry of the
  mesh. The `data` axis is laid out process-major: each process feeds
  its rows of the global batch. Along the other axes every process is
  fed the same batch and takes its own slice where a spec splits a
  dimension over them (`NamedSharding.local_slices`). Each process
  stores only its shard of a sharded parameter. Collectives over an
  axis run in the gloo sub-group of the processes that differ only
  along it (`Mesh.group`).

`check_mesh` takes every axis of the JAX package: data, model, seq,
pipe, expert, fsdp and tp. Across processes the `pipe` axis gives each
process a contiguous block of a pipeline's stages (`stage_blocks`) and
its neighbours along the axis (`Mesh.group(("pipe",))`, the members in
stage order); the `expert` axis splits no input (parallel/moe.py).
`PartitionSpec` and `NamedSharding` are the port's own types, with the
JAX types' fields.
"""
from __future__ import annotations

import collections

import numpy as np

from .. import _dist_bootstrap
from ..base import MXNetError
from ..context import Context

_current_mesh = None

# canonical axis names, in nesting order
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"

MeshDevice = collections.namedtuple("MeshDevice",
                                    ("process_index", "context"))


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: an axis name, a tuple of
    them, or None (unsharded), one entry a leading dimension."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _grid(devices):
    """An object array of MeshDevice entries from an array or a flat list
    of MeshDevice entries or Contexts (a Context alone is process 0's)."""
    if isinstance(devices, np.ndarray):
        shape, flat = devices.shape, list(devices.flat)
    else:
        flat = list(devices)
        shape = (len(flat),)
    out = np.empty(len(flat), dtype=object)
    for i, d in enumerate(flat):
        out[i] = d if isinstance(d, MeshDevice) else MeshDevice(0, d)
    return out.reshape(shape)


class Mesh:
    """A grid of MeshDevice entries with one name an axis."""

    def __init__(self, devices, axis_names):
        devs = _grid(devices)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devs.shape} needs "
                             f"{devs.ndim} axis names, got {axis_names}")
        self.devices = devs
        self.axis_names = axis_names

    @property
    def shape(self):
        """{axis name: size}, in axis order."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def contexts(self):
        """The Contexts of this process's entries, in mesh order."""
        me = _dist_bootstrap.process_index()
        return [d.context for d in self.devices.flat
                if d.process_index == me]

    @property
    def process_count(self):
        return len({d.process_index for d in self.devices.flat})

    def coords(self, rank=None):
        """The mesh index of process `rank`'s entry (this process's when
        None): across processes every process is one entry."""
        rank = _dist_bootstrap.process_index() if rank is None else rank
        for idx in np.ndindex(self.devices.shape):
            if self.devices[idx].process_index == rank:
                return idx
        raise ValueError(f"process {rank} has no entry in {self!r}")

    def axis_index(self, axis, rank=None):
        """Process `rank`'s coordinate along `axis` (0 in one process)."""
        if self.process_count <= 1:
            return 0
        return self.coords(rank)[self.axis_names.index(axis)]

    def group(self, axes):
        """(gloo process group, member ranks) of the processes that share
        this process's coordinates off `axes`, the members ordered by
        their index along `axes` (the first axis major): the group a
        collective over those axes runs in. (None, [me]) when only this
        process is in it. Every process must ask for the same axes in
        the same order: each call makes the groups of every slice."""
        axes = tuple(a for a in axes if a in self.axis_names)
        key = axes
        cache = self.__dict__.setdefault("_groups", {})
        if key in cache:
            return cache[key]
        me = _dist_bootstrap.process_index()
        if self.process_count <= 1 or not axes:
            cache[key] = (None, [me])
            return cache[key]
        import torch.distributed as dist

        pos = [self.axis_names.index(a) for a in axes]
        others = [i for i in range(len(self.axis_names)) if i not in pos]
        slices = {}
        for idx in np.ndindex(self.devices.shape):
            off = tuple(idx[i] for i in others)
            along = tuple(idx[i] for i in pos)
            slices.setdefault(off, []).append(
                (along, self.devices[idx].process_index))
        world = dist.get_world_size()
        mine = None
        for off in sorted(slices):
            members = [r for _a, r in sorted(slices[off])]
            if len(members) == world:
                pg = None          # the default group
            else:
                pg = dist.new_group(sorted(members))
            if me in members:
                mine = (pg, members)
        cache[key] = mine
        return mine

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self):
        return hash((self.axis_names, tuple(self.devices.flat)))

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


class NamedSharding:
    """A layout over a mesh: `spec` names the mesh axes each leading
    dimension is split over."""

    def __init__(self, mesh, spec=None):
        self.mesh = mesh
        self.spec = parse_partition_spec(spec)

    @property
    def device_set(self):
        """The mesh entries the layout spans."""
        return set(self.mesh.devices.flat)

    @property
    def is_fully_replicated(self):
        return all(d is None for d in self.spec)

    def process_split(self):
        """[(dim, axes, parts, index)] of every dimension split over mesh
        axes across processes: the axes, the number of parts and this
        process's part. The 'data' axis is left out: across processes
        each process is fed its own rows of it already. [] in one
        process."""
        mesh = self.mesh
        if mesh.process_count <= 1:
            return []
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in (entry if isinstance(entry, tuple)
                                     else (entry,)) if a is not None
                         and a != DATA_AXIS and a in mesh.axis_names)
            if not axes:
                continue
            parts, index = 1, 0
            for a in axes:
                n = mesh.shape[a]
                index = index * n + mesh.axis_index(a)
                parts *= n
            if parts > 1:
                out.append((dim, axes, parts, index))
        return out

    def data_split(self):
        """(dim, parts) where a dimension is split over the process-major
        'data' axis across processes (each process feeds its rows), else
        None."""
        mesh = self.mesh
        if mesh.process_count <= 1:
            return None
        for dim, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if DATA_AXIS in axes and DATA_AXIS in mesh.axis_names:
                return dim, mesh.shape[DATA_AXIS]
        return None

    def local_slices(self, shape):
        """This process's slice of an array of `shape` fed whole (the
        'data' axis excluded, see `process_split`): one slice a
        dimension."""
        sl = [slice(None)] * len(shape)
        for dim, _axes, parts, index in self.process_split():
            if shape[dim] % parts:
                raise ValueError(
                    f"dimension {dim} of {tuple(shape)} does not split "
                    f"into {parts} parts over {self.spec}")
            step = shape[dim] // parts
            sl[dim] = slice(index * step, (index + 1) * step)
        return tuple(sl)

    def local_shape(self, shape):
        """The shape of this process's slice of `shape` fed whole."""
        return tuple(
            len(range(*s.indices(n))) for s, n in
            zip(self.local_slices(shape), shape))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def one_device(contexts, what):
    """The one torch device of `contexts` (Contexts of this process), or
    MXNetError naming tools/launch.py when they name distinct CUDA
    cards: the port drives one card a process."""
    cards = sorted({c.device_id for c in contexts
                    if c.device_type == "gpu"})
    kinds = {c.device_type for c in contexts}
    if len(cards) > 1 or len(kinds) > 1:
        raise MXNetError(
            f"{what}: a data mesh over {list(contexts)} in one process; "
            "the port runs one process a CUDA card: start one worker a "
            "card with tools/launch.py (python tools/launch.py -n N "
            "python train.py) and train with kvstore='dist_sync'")
    return contexts[0].torch_device()


ALL_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS,
            FSDP_AXIS, TP_AXIS)


def check_axes(sizes, what):
    """MXNetError for an axis of {axis: size} that is not a mesh axis."""
    unknown = [a for a in sizes if a not in ALL_AXES]
    if unknown:
        raise MXNetError(f"{what}: {unknown} are not mesh axes "
                         f"({list(ALL_AXES)})")


def check_mesh(mesh, what):
    """The number of processes `mesh` spans, when `what` can use it: a
    Mesh over mesh axes whose entries in one process are one torch
    device, or across processes one entry a process. MXNetError
    otherwise."""
    if not isinstance(mesh, Mesh):
        raise MXNetError(
            f"{what} takes a parallel.mesh.Mesh, not "
            f"{type(mesh).__name__}")
    check_axes(mesh.shape, what)
    nproc = mesh.process_count
    if nproc == 1:
        one_device(mesh.contexts, what)
    elif nproc != mesh.size:
        raise MXNetError(
            f"{what}: a mesh of {mesh.size} entries over {nproc} "
            "processes; across processes each process is one entry")
    return nproc


def stage_blocks(mesh, num_stages, axis=PIPE_AXIS):
    """[(first, stop)] of the stages each member along `axis` holds, in
    member order: across processes a contiguous block of
    num_stages / size stages a process (MXNetError when the size does
    not divide them), in one process every stage on its one device."""
    size = mesh.shape.get(axis, 1) if mesh.process_count > 1 else 1
    if num_stages % size:
        raise MXNetError(
            f"{num_stages} pipeline stages do not split into blocks over "
            f"the {size} processes of mesh axis '{axis}'")
    step = num_stages // size
    return [(i * step, (i + 1) * step) for i in range(size)]


def _local_devices(n):
    """This process's first n mesh devices: its CUDA cards, else host
    contexts (`cpu(i)` all name the host, as the JAX package's virtual
    host devices share one CPU)."""
    import torch

    if torch.cuda.is_available():
        k = torch.cuda.device_count()
        if n > k:
            raise ValueError(f"a mesh of {n} devices in one process, but "
                             f"this process sees {k} CUDA device(s)")
        return [Context("gpu", i) for i in range(n)]
    return [Context("cpu", i) for i in range(n)]


def _job_devices(n):
    """The first n devices of the job, process-major. In one process,
    this process's devices; across processes, one entry a process: its
    current device (workers may share one card)."""
    nproc = _dist_bootstrap.process_count()
    if nproc == 1:
        return [MeshDevice(0, c) for c in _local_devices(n)]
    import torch

    mine = Context("gpu", torch.cuda.current_device()) \
        if torch.cuda.is_available() else Context("cpu", 0)
    # the other processes' entries are named as this one's: one kind of
    # device across the job
    devs = [MeshDevice(r, mine) for r in range(nproc)]
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices over {nproc} processes "
                         "of one device each")
    return devs[:n]


def data_parallel_mesh(n_devices=None):
    """A 1-D mesh with a 'data' axis over every device of the job (one a
    process across processes, this process's cards or the host in one
    process), or the first n."""
    nproc = _dist_bootstrap.process_count()
    if n_devices is None:
        n_devices = nproc if nproc > 1 else _count_local()
    return Mesh(_job_devices(n_devices), (DATA_AXIS,))


def _count_local():
    """This process's devices: its CUDA cards, else the host (1)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def job_device_count():
    """The job's devices as `data_parallel_mesh` counts them: one a
    process across processes, this process's devices in one."""
    nproc = _dist_bootstrap.process_count()
    return nproc if nproc > 1 else _count_local()


def make_mesh(axis_sizes: dict):
    """A mesh from {axis_name: size} over the job's first prod(sizes)
    devices, e.g. {'data': 2, 'model': 4}. Across processes the 'data'
    axis is laid out process-major whatever its position: each process
    feeds a contiguous slice of the global batch."""
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes)) if sizes else 1
    devs = _grid(_job_devices(n))
    if _dist_bootstrap.process_count() > 1 and DATA_AXIS in names \
            and len(names) > 1:
        di = names.index(DATA_AXIS)
        order = (di,) + tuple(i for i in range(len(names)) if i != di)
        arr = devs.reshape(tuple(sizes[i] for i in order))
        arr = np.transpose(arr, np.argsort(order))
    else:
        arr = devs.reshape(sizes)
    return Mesh(arr, names)


def parse_partition_spec(spec):
    """A PartitionSpec from a PartitionSpec, a tuple, None, or the string
    syntax of Symbol `__sharding__` attributes: comma-separated entries,
    each an axis name, 'None'/'*' (unsharded) or 'a+b' (several axes),
    e.g. "None,model" or "data+seq"."""
    if spec is None:
        return PartitionSpec()
    if isinstance(spec, PartitionSpec):
        return spec
    if isinstance(spec, (tuple, list)) or (
            not isinstance(spec, str) and hasattr(spec, "__iter__")):
        # a tuple, or another library's PartitionSpec (iterable by dim)
        return PartitionSpec(*tuple(spec))
    s = str(spec).strip()
    if not s or s == "None":
        return PartitionSpec()
    dims = []
    for part in s.split(","):
        part = part.strip()
        if part in ("None", "", "*"):
            dims.append(None)
        elif "+" in part:
            dims.append(tuple(p.strip() for p in part.split("+")))
        else:
            dims.append(part)
    return PartitionSpec(*dims)


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh


def current_mesh():
    return _current_mesh


class use_mesh:
    """Context manager installing `mesh` as the ambient mesh."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        global _current_mesh
        self._prev = _current_mesh
        _current_mesh = self._mesh
        return self._mesh

    def __exit__(self, *exc):
        global _current_mesh
        _current_mesh = self._prev
        return False


def default_mesh():
    """The current mesh, or a new data-parallel mesh over the job."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = data_parallel_mesh()
    return _current_mesh


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def batch_sharded(mesh, axis=0, mesh_axis=DATA_AXIS):
    spec = [None] * (axis + 1)
    spec[axis] = mesh_axis
    return NamedSharding(mesh, PartitionSpec(*spec))


class ProcessLocal:
    """This process's part of a global array placed by `global_put`: the
    `local` tensor, its `sharding` and the global `shape`."""

    __slots__ = ("local", "sharding", "shape")

    def __init__(self, local, sharding, shape):
        self.local = local
        self.sharding = sharding
        self.shape = tuple(shape)


def global_put(value, sharding):
    """Place a host value (the same on every process) under `sharding`:
    on this process's first context of the mesh, and across processes
    only this process's part where a dimension is split over them (its
    rows of the data axis, its slice along the others)."""
    import torch

    host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                      else value)
    part = host
    split = sharding.data_split()
    if split is not None:
        dim, nproc = split
        if host.shape[dim] % nproc:
            raise ValueError(f"dimension {dim} of {host.shape} does not "
                             f"split over {nproc} processes")
        step = host.shape[dim] // nproc
        me = sharding.mesh.axis_index(DATA_AXIS)
        part = np.take(host, range(me * step, (me + 1) * step), axis=dim)
    part = part[sharding.local_slices(part.shape)]
    ctx = sharding.mesh.contexts[0]
    local = torch.as_tensor(np.ascontiguousarray(part)).to(
        ctx.torch_device())
    return ProcessLocal(local, sharding, host.shape)


def full_host(arr):
    """The whole global value of `arr` as a numpy array, on every process.
    For a ProcessLocal split over processes this is a collective (every
    process must call it): the parts are gathered over the gloo group."""
    if not isinstance(arr, ProcessLocal):
        if hasattr(arr, "asnumpy"):
            return arr.asnumpy()
        if hasattr(arr, "detach"):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)
    from . import collective

    sh = arr.sharding
    local = arr.local.detach()
    for dim, axes, _parts, _index in reversed(sh.process_split()):
        local = collective.gather_axes(local, sh.mesh, axes, dim)
    split = sh.data_split()
    if split is not None:
        local = collective.gather_axes(local, sh.mesh, (DATA_AXIS,),
                                       split[0])
    return local.cpu().numpy()
