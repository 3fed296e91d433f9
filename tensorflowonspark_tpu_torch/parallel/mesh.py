"""Meshes of processes (port of the JAX package's ``parallel/mesh.py``,
cut to what data and sequence parallelism need).

The reference names the axes of a ``jax.sharding.Mesh`` over devices and
lets XLA lower collectives onto them.  The port runs one process per GPU
(one ``torch.distributed`` rank), so a :class:`Mesh` lays the ranks out
row-major over named axes and holds one ``torch.distributed`` group for
each line of each axis that this rank lies on: the ``seq`` group of a
``{"data": 2, "seq": 2}`` mesh over four ranks is ``[0, 1]`` on ranks 0
and 1 and ``[2, 3]`` on ranks 2 and 3.  A mesh is built by every rank
of the default group in the same order, since ``dist.new_group`` is
collective.

Axis names and their order are the reference's (``data`` slowest,
``seq`` and ``model`` fastest); only ``data``, ``fsdp`` and ``seq``
have users in the port so far.
"""

import math

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_SEQ = "seq"

#: the reference's canonical mesh order of its axis names, so that a
#: ``MeshSpec`` of keyword axes lays the ranks out as the reference does
CANONICAL_ORDER = ("pipe", AXIS_DATA, "ps", AXIS_FSDP, "expert", AXIS_SEQ,
                   "model")


class MeshSpec(object):
    """Declarative mesh shape: ordered ``(axis_name, size)`` pairs.

    ``size == -1`` on at most one axis means "absorb all remaining
    ranks".  Example::

        MeshSpec(data=-1, seq=2)        # 4 ranks -> data=2, seq=2
        MeshSpec.from_axes([("seq", 2), ("data", -1)])
    """

    def __init__(self, **axes):
        # canonical order for kwargs; explicit order via from_axes
        ordered = [(n, axes.pop(n)) for n in CANONICAL_ORDER if n in axes]
        if axes:
            # unknown axis names are allowed (user-defined), appended last
            ordered.extend(sorted(axes.items()))
        self.axes = ordered

    @classmethod
    def from_axes(cls, axes):
        spec = cls()
        spec.axes = [(str(n), int(s)) for n, s in axes]
        return spec

    def resolve(self, num_devices):
        """Concretize ``-1`` and validate the factorization."""
        names = [n for n, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate axis names in {0}".format(names))
        sizes = [s for _, s in self.axes]
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may have size -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if num_devices % fixed != 0:
                raise ValueError(
                    "fixed axes {0} do not divide device count {1}".format(
                        fixed, num_devices
                    )
                )
            sizes[wild[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                "mesh {0} needs {1} devices, have {2}".format(
                    self.axes, fixed, num_devices
                )
            )
        return list(zip(names, sizes))


class Mesh(object):
    """Ranks laid out row-major over named axes, seen from one rank.

    ``axis_names`` and ``shape`` (``{axis: size}``) are the reference
    mesh's; ``ranks`` are the global ranks in mesh order, ``coords`` this
    rank's index on each axis.  :meth:`group` is the process group of
    this rank's line along an axis (``None`` for an axis of size 1),
    :attr:`world_group` the group of all the mesh's ranks (``None`` for
    a mesh of one rank).
    """

    def __init__(self, names, sizes, ranks, rank, lines, world_group):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.ranks = tuple(ranks)
        self.rank = rank
        index = self.ranks.index(rank)
        coords = {}
        for name, size in reversed(list(zip(names, sizes))):
            index, coords[name] = divmod(index, size)
        self.coords = {name: coords[name] for name in names}
        self._lines = lines
        self.world_group = world_group

    @property
    def size(self):
        return len(self.ranks)

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def axis_index(self, name):
        """This rank's index along ``name`` (0 for an absent axis)."""
        return self.coords.get(name, 0)

    def group(self, name):
        """The process group of this rank's line along ``name``."""
        return self._lines.get(name, (None, None))[0]

    def line(self, name):
        """The global ranks of this rank's line along ``name``, in axis
        order (this rank alone for an absent or size-1 axis)."""
        return self._lines.get(name, (None, [self.rank]))[1]

    def __repr__(self):
        return "Mesh({0}, rank {1} at {2})".format(self.shape, self.rank,
                                                   self.coords)


def _distributed():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def build_mesh(axes=None, devices=None):
    """Build a :class:`Mesh` over the ranks of the default process group.

    Args:
      axes: ``None`` (all ranks on ``data``), a :class:`MeshSpec`, a dict
        ``{axis: size}``, or an ordered list of ``(axis, size)`` pairs;
        ``-1`` absorbs the remaining ranks.
      devices: the global ranks the mesh spans, in mesh order (default:
        every rank of the default group; one rank when no process group
        is initialised).

    Every rank of the default group must call this, with the same
    arguments and in the same order as its other group creations.  A
    rank outside ``devices`` takes part in creating the groups and gets
    ``None``.
    """
    dist = _distributed()
    world = dist.get_world_size() if dist else 1
    rank = dist.get_rank() if dist else 0
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError("devices must be distinct ranks of a world of "
                         "{0}, got {1}".format(world, ranks))
    if axes is None:
        axes = MeshSpec(**{AXIS_DATA: -1})
    elif isinstance(axes, dict):
        axes = MeshSpec(**axes)
    elif isinstance(axes, (list, tuple)):
        axes = MeshSpec.from_axes(axes)
    resolved = axes.resolve(len(ranks))
    names = [name for name, _ in resolved]
    sizes = [size for _, size in resolved]
    lines = {}
    for i, name in enumerate(names):
        if sizes[i] == 1:
            continue
        stride = math.prod(sizes[i + 1:])
        for start in range(len(ranks)):
            if (start // stride) % sizes[i]:
                continue  # not the first rank of its line
            line = [ranks[start + j * stride] for j in range(sizes[i])]
            group = dist.new_group(line)
            if rank in line:
                lines[name] = (group, line)
    world_group = None
    if len(ranks) > 1:
        world_group = (dist.group.WORLD if len(ranks) == world
                       else dist.new_group(ranks))
    if rank not in ranks:
        return None
    return Mesh(names, sizes, ranks, rank, lines, world_group)


def mesh_axis_size(mesh, *axis_names):
    """Product of the named axes' sizes (1 for absent axes)."""
    size = 1
    for name in axis_names:
        size *= mesh.shape.get(name, 1)
    return size


def local_batch_size(mesh, global_batch_size,
                     data_axes=(AXIS_DATA, AXIS_FSDP)):
    """Rows of the global batch that each rank is given: the global batch
    split over the data-parallel width.  (The reference divides by the
    process count, each of its processes feeding all its devices; here a
    process is one GPU, and the ranks of one ``seq`` line take the same
    rows.)"""
    width = mesh_axis_size(mesh, *data_axes)
    if global_batch_size % width != 0:
        raise ValueError(
            "global batch {0} not divisible by data-parallel width "
            "{1}".format(global_batch_size, width)
        )
    return global_batch_size // width
