"""A mesh of devices in one process, and the helpers that shard rows over it
(counterpart of ``pinnfc_tpu/parallel/mesh.py``).

The JAX package's ``--data-parallel`` is one flag of one process over every
visible chip: a ``jax.sharding.Mesh`` that XLA compiles collectives for.  The
port keeps that shape.  A ``Mesh`` is an array of ``torch.device`` entries with
named axes; a sharded caller puts row shard k on the k-th device of the
``"data"`` axis, runs its kernels there on each device's current stream, and
sums the partial results with ``all_sum``: on the mesh's first device, in mesh
order, always the same order, with no float atomics and no process group.  A
mesh may list one device several times (``make_mesh(devices=["cuda:0"] * 4)``
runs the sharded code paths, kernels included, on one card; the tests list
the CPU k times, as the JAX tests run on 8 virtual CPU devices).

A data axis of size 1 is no sharding: every sharded caller then takes its
unsharded path exactly.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Devices in an array of ``shape``, one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data", index: int = 0) -> List[torch.device]:
        """The devices along ``axis``, at ``index`` of every other axis."""
        k = self.axis_names.index(axis)
        sel = [index] * self.devices.ndim
        sel[k] = slice(None)
        return list(self.devices[tuple(sel)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def visible_devices(device: str = "cuda") -> List[torch.device]:
    """The devices a mesh may span: every CUDA device torch sees for
    ``"cuda"`` (none without CUDA), the CPU once for ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device; the list may repeat a device).  Default layout: one
    ``"data"`` axis over all of them; pass ``axis_names=("model", "data")``
    with a ``shape`` for a 2-D layout (members × rows)."""
    devs = visible_devices() if devices is None else [torch.device(d) for d in devices]
    n = len(devs) if n_devices is None else int(n_devices)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} visible")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("multi-axis mesh needs an explicit shape")
    return Mesh(arr.reshape(tuple(int(s) for s in shape)), axis_names)


def data_size(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's ``"data"`` axis; 1 without a mesh."""
    return 1 if mesh is None else mesh.shape["data"]


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad with edge rows so ``shape[axis] % multiple == 0``; returns
    (padded, original length).  A numpy array or a torch tensor."""
    n = array.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return array, n
    if isinstance(array, torch.Tensor):
        edge = array.narrow(axis, n - 1, 1)
        reps = [1] * array.dim()
        reps[axis] = rem
        return torch.cat([array, edge.repeat(*reps)], dim=axis), n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, rem)
    return np.pad(np.asarray(array), pad_width, mode="edge"), n


class RowShards(NamedTuple):
    """Rows split over devices: shard k is ``parts[k]`` (one tensor per array)
    on its device, its first row global row ``offsets[k]``; ``n`` rows in all."""

    parts: Tuple[Tuple[torch.Tensor, ...], ...]
    offsets: Tuple[int, ...]
    n: int

    def array(self, i: int) -> List[torch.Tensor]:
        """Array ``i``'s shards, in order."""
        return [p[i] for p in self.parts]

    @property
    def devices(self) -> List[torch.device]:
        return [p[0].device for p in self.parts]


def split_rows(arrays: Sequence[torch.Tensor], sizes: Sequence[int],
               devices: Sequence[torch.device]) -> RowShards:
    """Cut the rows of every array into consecutive pieces of ``sizes`` rows,
    piece k on ``devices[k]``; empty pieces are dropped."""
    n = int(arrays[0].shape[0])
    if sum(sizes) != n or any(a.shape[0] != n for a in arrays):
        raise ValueError(f"pieces of {list(sizes)} rows do not cover {n} rows")
    parts, offsets, off = [], [], 0
    for size, dev in zip(sizes, devices):
        if size > 0:
            parts.append(tuple(a[off:off + size].to(dev) for a in arrays))
            offsets.append(off)
        off += size
    return RowShards(tuple(parts), tuple(offsets), n)


def shard_batch(mesh: Mesh, *arrays: torch.Tensor, axis: str = "data",
                index: int = 0) -> RowShards:
    """Rows split evenly over the mesh axis' devices (at ``index`` of the other
    axes).  Pads nothing: N must divide by the axis size."""
    devices = mesh.axis_devices(axis, index)
    n, k = int(arrays[0].shape[0]), len(devices)
    if n % k:
        raise ValueError(f"{n} rows do not divide over {k} devices; pad_to_multiple first")
    return split_rows(arrays, [n // k] * k, devices)


def block_sizes(n: int, parts: int, block: int) -> List[int]:
    """Rows of ``parts`` consecutive pieces of ``n`` rows cut at multiples of
    ``block`` rows: ⌈⌈n / block⌉ / parts⌉ blocks each, the last ones shorter
    or empty."""
    per = -(-(-(-n // block)) // parts) * block
    return [max(0, min(per, n - k * per)) for k in range(parts)]


def gather_rows(shards: Sequence[torch.Tensor], n: Optional[int] = None) -> torch.Tensor:
    """The shards' rows concatenated on the first shard's device, cut to ``n``
    rows (the padding trimmed)."""
    dev = shards[0].device
    out = torch.cat([s.to(dev) for s in shards])
    return out if n is None else out[:n]


def to_device(tree, device):
    """``tree`` (a tensor, a module, or a dict, list or tuple of them) on
    ``device``: the same objects where they lie there already, else copies
    (a module is copied, never moved in place)."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.nn.Module):
        p = next(tree.parameters(), None)
        if p is None or p.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def replicate(mesh: Mesh, tree, axis: str = "data") -> list:
    """One copy of ``tree`` per device of the mesh axis; a device that lies
    where ``tree`` does (or repeats an earlier one) shares that object."""
    out, seen = [], {}
    for dev in mesh.axis_devices(axis):
        if dev not in seen:
            seen[dev] = to_device(tree, dev)
        out.append(seen[dev])
    return out


def all_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ parts on the first part's device, added in order (the same order on
    every call, so a sum is the same from run to run)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc
