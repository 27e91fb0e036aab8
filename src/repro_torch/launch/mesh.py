"""The tablet mesh: one 1-D axis ``"tablets"`` over an ordered list of
devices, one device per tablet (the port of ``repro.launch.mesh.
make_tablet_mesh``; the LM meshes of that module are not ported).

A table gets a mesh when more than one device is *visible*, the
reference's rule (``repro.api.table``).  On ``cuda`` the visible devices
are the cards.  The environment variable ``REPRO_TORCH_HOST_DEVICES=N``
is the counterpart of the reference's
``--xla_force_host_platform_device_count=N``: N tablets, placed
round-robin over the physical devices of the table's device type (N x
``cpu`` in the tests, N x ``cuda:0`` on a one-card machine).  It is
read when a table resolves its mesh, never at import;
``python -m repro_torch.launch.serve --host-devices N`` sets it.

One process drives every tablet (single controller, as the reference's
``shard_map``); ``distributed.collectives`` moves tensors between them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

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
