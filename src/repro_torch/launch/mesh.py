"""The port's meshes (``repro.launch.mesh``).

The tablet mesh: one 1-D axis ``"tablets"`` over an ordered list of
devices, one device per tablet (``make_tablet_mesh``).  The LM mesh
(``Mesh``): named axes such as ``("data", "model")`` over shards in
row-major order (``make_mesh``, ``make_production_mesh``,
``make_pipeline_mesh``).

A table gets a mesh when more than one device is *visible*, the
reference's rule (``repro.api.table``).  On ``cuda`` the visible devices
are the cards.  The environment variable ``REPRO_TORCH_HOST_DEVICES=N``
is the counterpart of the reference's
``--xla_force_host_platform_device_count=N``: N tablets, placed
round-robin over the physical devices of the table's device type (N x
``cpu`` in the tests, N x ``cuda:0`` on a one-card machine).  It is
read when a table resolves its mesh, never at import;
``python -m repro_torch.launch.serve --host-devices N`` sets it.

One process drives every tablet or shard (single controller, as the
reference's ``shard_map``); ``distributed.collectives`` moves tensors
between them.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device

HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"
AXIS = "tablets"


@dataclasses.dataclass(frozen=True)
class TabletMesh:
    """A 1-D mesh: ``devices[d]`` holds tablet ``d``."""
    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return (AXIS,)

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def host_device_count() -> Optional[int]:
    """``REPRO_TORCH_HOST_DEVICES`` as a positive int, None when unset."""
    raw = os.environ.get(HOST_DEVICES_ENV, "").strip()
    if not raw:
        return None
    n = int(raw)
    if n < 1:
        raise ValueError(f"{HOST_DEVICES_ENV}={raw!r}: need a count >= 1")
    return n


def _physical(dev: torch.device) -> list:
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def visible_devices(device: DeviceLike = None) -> list:
    """The devices a table on ``device`` sees: the host-device count's
    round-robin placement when it is set, else every card (``cuda``) or
    the one device (anything else)."""
    dev = resolve_device(device)
    phys = _physical(dev)
    n = host_device_count()
    if n is None:
        return phys
    return [phys[i % len(phys)] for i in range(n)]


def make_tablet_mesh(num_devices: Optional[int] = None,
                     device: DeviceLike = None) -> TabletMesh:
    """A mesh of ``num_devices`` tablets (every visible device when
    None), placed round-robin over the devices of ``device``'s type."""
    n = len(visible_devices(device)) if num_devices is None \
        else int(num_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one tablet, got {n}")
    phys = _physical(resolve_device(device))
    return TabletMesh(devices=tuple(phys[i % len(phys)] for i in range(n)))


def table_mesh(device: DeviceLike = None) -> Optional[TabletMesh]:
    """The reference's rule for a table: a mesh over every visible device
    when more than one is visible, else None."""
    n = len(visible_devices(device))
    return make_tablet_mesh(n, device) if n > 1 else None


# ---------------------------------------------------------------------------
# The LM mesh: named axes over shards
# ---------------------------------------------------------------------------
def _axes(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ``prod(axis_sizes)`` shards: ``devices[i]`` holds
    shard ``i``, the row-major index of its coordinates (jax's device
    order).  A ``descriptor`` mesh has more shards than the devices it
    was placed on and exists for the sharding rules: executing on it is
    bounded by ``require_room``."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple
    descriptor: bool = False

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, i: int) -> tuple:
        """Shard ``i``'s coordinate along each axis."""
        out = []
        for s in reversed(self.axis_sizes):
            out.append(i % s)
            i //= s
        return tuple(reversed(out))

    def index_along(self, i: int, axis_name) -> int:
        """Shard ``i``'s index along ``axis_name`` (a name or a tuple of
        names, row-major in the order given): ``lax.axis_index``."""
        c = dict(zip(self.axis_names, self.coords(i)))
        idx = 0
        for a in _axes(axis_name):
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_size(self, axis_name) -> int:
        """Shards along ``axis_name`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axis_name))

    def groups(self, axis_name) -> list:
        """The shards that share every coordinate outside ``axis_name``,
        one list per group in order of their first shard, each ordered by
        its index along ``axis_name``."""
        axes = _axes(axis_name)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh axes "
                                 f"{self.axis_names}")
        keyed: dict = {}
        for i in range(self.size):
            c = self.coords(i)
            rest = tuple(x for a, x in zip(self.axis_names, c)
                         if a not in axes)
            keyed.setdefault(rest, [None] * self.axis_size(axes))
            keyed[rest][self.index_along(i, axes)] = i
        return list(keyed.values())

    def require_room(self, shard_bytes: int, what: str) -> None:
        """On a descriptor mesh, raise unless every device can hold
        ``shard_bytes`` for each shard placed on it -- what ``what``
        would hold on one real device per shard.  Other meshes run
        whatever their devices hold, and so does a mesh of ``meta``
        devices (the dry run's: shapes only, nothing allocated)."""
        if not self.descriptor:
            return
        per_dev = collections.Counter(self.devices)
        for dev, n in per_dev.items():
            need, room = int(shard_bytes) * n, _device_bytes(dev)
            if need > room:
                raise RuntimeError(
                    f"{what}: {shard_bytes} bytes a shard on this "
                    f"{dict(self.shape)} mesh needs {self.size} devices "
                    f"of at least {shard_bytes} bytes; here {n} shards "
                    f"share {dev} ({room} bytes), which holds this mesh "
                    f"only as a descriptor of the sharding rules (a "
                    f"reduced config runs on it)")


def _device_bytes(dev: torch.device) -> float:
    if dev.type == "meta":
        return math.inf
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """``jax.make_mesh``: one shard per visible device of ``device``'s
    type (``REPRO_TORCH_HOST_DEVICES=N`` gives N shards round-robin over
    them), or per entry of ``devices`` (shards may share a device); the
    shape's product must equal that count."""
    shape = tuple(int(s) for s in axis_shapes)
    if devices is not None:
        return Mesh(tuple(axis_names), shape,
                    tuple(torch.device(d) for d in devices))
    devs = visible_devices(device)
    n = math.prod(shape)
    if n != len(devs):
        raise ValueError(
            f"a {shape} mesh needs {n} devices and {len(devs)} are "
            f"visible; set {HOST_DEVICES_ENV}={n} for {n} shards on the "
            f"devices there are")
    return Mesh(tuple(axis_names), shape, tuple(devs))


def _fixed_mesh(shape: tuple, names: tuple, device: DeviceLike) -> Mesh:
    """``shape`` over the visible devices when there are that many, else
    a descriptor placed round-robin over the physical ones."""
    n = math.prod(shape)
    devs = visible_devices(device)
    if len(devs) == n:
        return Mesh(names, shape, tuple(devs))
    phys = _physical(resolve_device(device))
    return Mesh(names, shape, tuple(phys[i % len(phys)] for i in range(n)),
                descriptor=True)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """(16, 16) ``data x model``, or (2, 16, 16) ``pod x data x model``."""
    if multi_pod:
        return _fixed_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _fixed_mesh((16, 16), ("data", "model"), device)


def make_pipeline_mesh(device: DeviceLike = None) -> Mesh:
    """The multi-pod mesh, its ``pod`` axis the pipeline's stages."""
    return _fixed_mesh((2, 16, 16), ("pod", "data", "model"), device)
