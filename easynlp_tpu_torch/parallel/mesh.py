"""The process mesh of the PyTorch port.

Counterpart of easynlp_tpu/parallel/mesh.py and of the process start in
easynlp_tpu/utils/initializer.py:85-116. JAX runs one SPMD program over a
`Mesh` of every local chip; here one process drives one device, as in
PyTorch, and the mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the processes, with the JAX package's named axes in its order
(AXIS_ORDER, outer to inner). Rank r sits at the row-major coordinate of r
over the axis sizes in that order, so `tensor`, the innermost axis, joins
neighbouring ranks.

`init_distributed(args)` starts the process group from the flags or from
what `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT): `nccl` where each rank has its own CUDA device, `gloo` on the
CPU, and `gloo` on CUDA tensors only when `--dist_backend=gloo` asks for
it. NCCL refuses two ranks on one device; that raises, there is no switch
to another backend. `build_mesh` then lays the axes over the world and
takes a process group for each axis and, by flattening its sub-meshes, for
each group of axes the port reduces over (`group`), all at once, since
every rank must take part in making each group.

A world of one process without `--mesh` starts no process group and has no
mesh: every axis has size 1 and every group is None.
"""

import itertools
import math
import os

import torch.distributed as dist

AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")
# the axes a host-fed batch is split over. JAX splits it over data and
# fsdp; here the expert axis splits it too, so expert parallelism sends
# each rank's own tokens to the experts' owners with all_to_all
BATCH_AXES = ("data", "fsdp", "expert")
# the groups of axes the port reduces over, made with the mesh
_COMBINED = (BATCH_AXES, BATCH_AXES + ("sequence",),
             ("data", "fsdp", "sequence"), ("expert", "sequence"))

_GLOBAL_MESH = None


class Mesh:
    """Axis sizes over AXIS_ORDER, this rank's coordinate, and a process
    group for each axis and for each group of axes in _COMBINED (None
    where the group has one member). `device_mesh` is the DeviceMesh over
    all six axes (FSDP2 takes its sub-meshes)."""

    def __init__(self, axis_sizes, rank=0, device_mesh=None, groups=None):
        unknown = set(axis_sizes) - set(AXIS_ORDER)
        if unknown:
            raise ValueError("unknown mesh axes %s (the port has %s)"
                             % (sorted(unknown), ", ".join(AXIS_ORDER)))
        self.shape = {a: int(axis_sizes.get(a, 1)) for a in AXIS_ORDER}
        self.world_size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = dict(zip(AXIS_ORDER, _unravel(rank, self.shape)))
        self.device_mesh = device_mesh
        self._groups = groups or {}

    def size(self, axes):
        """The number of ranks along an axis or a tuple of axes."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes):
        """This rank's index along an axis or a tuple of axes (row-major
        over them, in AXIS_ORDER)."""
        axes = [a for a in AXIS_ORDER if a in _axes(axes)]
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank's neighbours along the axes (the
        ranks whose other coordinates equal this rank's); None when the
        axes hold one rank."""
        key = _key(axes, self.shape)
        if not key:
            return None
        if key not in self._groups:
            raise KeyError("no process group was made for axes %s" % (key,))
        return self._groups[key]

    def ranks(self, axes):
        """The global ranks of this rank's group along the axes, in
        index order."""
        return _group_ranks(_key(axes, self.shape), self.shape, self.coords)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % (a, n) for a, n in
                                      self.shape.items() if n > 1)


def _axes(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _key(axes, shape):
    """The axes of size above 1, in AXIS_ORDER: groups that differ only by
    size-1 axes are one group."""
    wanted = set(_axes(axes))
    return tuple(a for a in AXIS_ORDER if a in wanted and shape[a] > 1)


def _unravel(rank, shape):
    coords = []
    for a in reversed(AXIS_ORDER):
        coords.append(rank % shape[a])
        rank //= shape[a]
    return tuple(reversed(coords))


def _ravel(coords, shape):
    r = 0
    for a in AXIS_ORDER:
        r = r * shape[a] + coords[a]
    return r


def _group_ranks(key, shape, coords):
    """Ranks that share every coordinate but those of `key`, in row-major
    order over `key`."""
    out = []
    for values in itertools.product(*(range(shape[a]) for a in key)):
        c = dict(coords)
        c.update(zip(key, values))
        out.append(_ravel(c, shape))
    return out


def parse_mesh_spec(spec, n_devices):
    """'dp=4,tp=2' -> an ordered {axis: size}: the port's copy of the JAX
    package's parse_mesh_spec (utils/arguments.py:192-222), with its
    aliases and its one "-1" axis that takes the remaining devices. The
    devices are the processes of the world, one device each."""
    if not spec:
        return {"data": n_devices}
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        alias = {"dp": "data", "tp": "tensor", "fsdp": "fsdp",
                 "sp": "sequence", "ep": "expert", "pp": "pipeline"}.get(
                     name, name)
        axes[alias] = int(size)
    wildcard = [k for k, v in axes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError("At most one mesh axis may be -1: %s" % spec)
    fixed = 1
    for k, v in axes.items():
        if v != -1:
            fixed *= v
    if wildcard:
        if n_devices % fixed:
            raise ValueError("Mesh %s does not divide %d devices"
                             % (spec, n_devices))
        axes[wildcard[0]] = n_devices // fixed
        fixed = n_devices
    if fixed != n_devices:
        raise ValueError("Mesh %s uses %d devices but %d are available"
                         % (spec, fixed, n_devices))
    return axes


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def wants_distributed(args):
    """True when the run needs a process group: more than one process, a
    --mesh, or a world that torchrun started."""
    return bool((args.num_processes or 1) > 1 or getattr(args, "mesh", None)
                or _env_int("WORLD_SIZE") is not None)


def local_rank(args):
    """LOCAL_RANK where torchrun set it, else the process index."""
    value = _env_int("LOCAL_RANK")
    return args.process_index if value is None else value


def _init_method(args):
    """The rendezvous: --coordinator_address (host:port, tcp://host:port or
    file:///path), else torchrun's MASTER_ADDR/MASTER_PORT, else, for a
    world of one process, an in-process store."""
    address = getattr(args, "coordinator_address", None)
    if address:
        if "://" in address:
            return {"init_method": address}
        return {"init_method": "tcp://" + address}
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return {"init_method": "env://"}
    if args.num_processes > 1:
        raise ValueError(
            "--num_processes=%d needs a rendezvous: pass "
            "--coordinator_address (host:port or file:///path) or start the "
            "processes with torchrun (MASTER_ADDR, MASTER_PORT)"
            % args.num_processes)
    return {"store": dist.HashStore()}


def backend_for(device, requested="auto"):
    """nccl for CUDA devices, gloo for the CPU; `requested` names one. gloo
    on CUDA tensors runs only when asked for."""
    if requested not in ("auto", "nccl", "gloo"):
        raise ValueError("--dist_backend=%s: auto, nccl or gloo" % requested)
    if requested == "auto":
        return "nccl" if device.type == "cuda" else "gloo"
    if requested == "nccl" and device.type != "cuda":
        raise ValueError("--dist_backend=nccl needs --device=cuda")
    return requested


def init_distributed(args, device):
    """Start (or join the running) default process group for args: its
    rank, world size, backend and rendezvous. Sets args.process_index,
    args.num_processes and args.dist_backend; returns the backend."""
    backend = backend_for(device, getattr(args, "dist_backend", "auto"))
    if dist.is_initialized():
        if dist.get_world_size() != args.num_processes \
                or dist.get_rank() != args.process_index:
            raise RuntimeError(
                "a process group of %d ranks (this rank %d) is running; the "
                "flags ask for %d (rank %d)" % (
                    dist.get_world_size(), dist.get_rank(),
                    args.num_processes, args.process_index))
        if dist.get_backend() != backend:
            raise RuntimeError("a %s process group is running; the flags "
                               "ask for %s" % (dist.get_backend(), backend))
        args.dist_backend = backend
        return backend
    kwargs = _init_method(args)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, rank=args.process_index,
                            world_size=args.num_processes, **kwargs)
    args.dist_backend = backend
    return backend


def build_mesh(axis_sizes, device_type="cpu"):
    """The Mesh of {axis: size} over the running process group (a world of
    one process needs none): the DeviceMesh over AXIS_ORDER, its group of
    each axis and of each flattened group in _COMBINED. Collective: every
    rank calls it together."""
    shape = {a: int(axis_sizes.get(a, 1)) for a in AXIS_ORDER}
    world = math.prod(shape.values())
    if not dist.is_initialized():
        if world != 1:
            raise ValueError("mesh %s needs %d processes and no process "
                             "group is running" % (axis_sizes, world))
        return Mesh(shape)
    if dist.get_world_size() != world:
        raise ValueError("mesh %s needs %d processes, the world has %d"
                         % (axis_sizes, world, dist.get_world_size()))
    from torch.distributed.device_mesh import init_device_mesh
    rank = dist.get_rank()
    device_mesh = init_device_mesh(
        device_type, tuple(shape[a] for a in AXIS_ORDER),
        mesh_dim_names=AXIS_ORDER)
    groups = {}
    for a in AXIS_ORDER:
        if shape[a] > 1:
            groups[(a,)] = device_mesh.get_group(a)
    for axes in _COMBINED:
        key = _key(axes, shape)
        if len(key) > 1 and key not in groups:
            # a 1-D mesh over these axes' sub-meshes: its group joins the
            # ranks that differ only along them
            groups[key] = device_mesh[key]._flatten(
                "_".join(key)).get_group()
    return Mesh(shape, rank, device_mesh, groups)


def set_global_mesh(mesh):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


def get_global_mesh():
    """The mesh of this process, None when it runs alone without one."""
    return _GLOBAL_MESH


def axis_size(axes, mesh=None):
    mesh = mesh or _GLOBAL_MESH
    return 1 if mesh is None else mesh.size(axes)


def axis_index(axes, mesh=None):
    mesh = mesh or _GLOBAL_MESH
    return 0 if mesh is None else mesh.index(axes)


def axis_group(axes, mesh=None):
    mesh = mesh or _GLOBAL_MESH
    return None if mesh is None else mesh.group(axes)


def data_parallel_size(mesh=None):
    """How many ways a host-fed batch is split (BATCH_AXES)."""
    return axis_size(BATCH_AXES, mesh)


def data_parallel_rank(mesh=None):
    return axis_index(BATCH_AXES, mesh)


def batch_sharding(n, mesh=None):
    """This rank's rows [start, stop) of a global batch of n rows: the
    contiguous block of its index over BATCH_AXES, as JAX's batch_sharding
    places a batch's leading axis over (data, fsdp)."""
    size, index = data_parallel_size(mesh), data_parallel_rank(mesh)
    if n % size:
        raise ValueError("a batch of %d rows does not split over %d "
                         "data-parallel ranks" % (n, size))
    per = n // size
    return index * per, (index + 1) * per


def destroy():
    """End the process group and drop the mesh."""
    set_global_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
