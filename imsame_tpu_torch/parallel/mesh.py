"""Device mesh: one process driving a [n_data, n_dict] grid of torch devices.

Two logical axes, as in the JAX package's mesh:
  data  -- query-read batches (the reference's pthread split analog)
  dict  -- k-mer-dictionary shards by row range

The JAX package's mesh is one process over the devices it can address;
parallelism across processes is task-level (distributed.py stripes the
sweep's jobs).  The port keeps that design: a Mesh is a grid of
``torch.device``s in one process, each shard a tensor on its position's
device, each step (parallel/sharded.py) one launch per position on that
device's current stream, and every merge an explicit ``.to(lead)``.  No
collective library is involved.

Positions run in JAX's flattened ("data", "dict") order: position
``d * n_dict + k`` is grid cell (d, k).  A device may fill several
positions (a grid on one card, or on the CPU in the tests); uploads then
go once per distinct device (replicated tables) or once per distinct
(device, shard) (sharded ones), and positions that share a device share
the tensor.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def visible_devices(device) -> List[torch.device]:
    """The devices a mesh of the engine's ``device`` spans by default:
    every visible card for ``"cuda"``, the named card alone for
    ``"cuda:k"``, the one CPU device for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _copy(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The upload of a Mesh built outside an engine: a plain copy,
    counted nowhere."""
    return torch.tensor(x, device=dev)


class Mesh:
    """A [n_data, n_dict] grid of torch devices (see the module
    docstring).  ``shape`` is {"data": n_data, "dict": n_dict}, ``size``
    the number of positions, ``devices`` the positions' devices in flat
    order and ``lead`` the first, where merged results land.  ``upload(x,
    device)`` sends a host array: an engine's mesh takes the engine's
    counted upload (TorchEngine._put)."""

    def __init__(self, devices: Sequence[torch.device], n_data: int,
                 n_dict: int, upload: Optional[Callable] = None):
        if len(devices) != n_data * n_dict:
            raise ValueError(f"{n_data}x{n_dict} mesh needs "
                             f"{n_data * n_dict} devices, got {len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"data": n_data, "dict": n_dict}
        self.size = n_data * n_dict
        self.lead = self.devices[0]
        self.upload = upload or _copy

    def grid(self, p: int):
        """(d, k): the data and dict coordinates of position p."""
        return divmod(p, self.shape["dict"])

    def _per_position(self, key, part) -> List[torch.Tensor]:
        """part(p) on each position's device, sent once per distinct
        (device, key(p)): a host array by ``upload``, a tensor by
        ``.to``."""
        done = {}
        out = []
        for p, dev in enumerate(self.devices):
            slot = (dev, key(p))
            if slot not in done:
                x = part(p)
                done[slot] = (x.to(dev) if isinstance(x, torch.Tensor)
                              else self.upload(x, dev))
            out.append(done[slot])
        return out

    def put(self, x) -> List[torch.Tensor]:
        """Replicate a numpy array or tensor: every position holds it."""
        return self._per_position(lambda p: None, lambda p: x)

    def put_rows(self, x) -> List[torch.Tensor]:
        """Shard a 1-D array by contiguous row range over "dict": position
        (d, k) holds rows [k * S, (k + 1) * S), S = len(x) // n_dict."""
        n_dict = self.shape["dict"]
        if len(x) % n_dict:
            raise ValueError(f"{len(x)} rows do not split over {n_dict}")
        S = len(x) // n_dict
        return self._per_position(
            lambda p: self.grid(p)[1],
            lambda p: x[self.grid(p)[1] * S : (self.grid(p)[1] + 1) * S],
        )

    def put_cols(self, x: np.ndarray, flat: bool = False) -> List[torch.Tensor]:
        """Shard the last axis of a host array: over "data" (position (d,
        k) holds column block d of n_data), or with ``flat`` over the
        flattened ("data", "dict") axis (position p holds block p)."""
        n = self.size if flat else self.shape["data"]
        if x.shape[-1] % n:
            raise ValueError(f"{x.shape[-1]} columns do not split over {n}")
        w = x.shape[-1] // n
        block = (lambda p: p) if flat else (lambda p: self.grid(p)[0])
        return self._per_position(
            block, lambda p: x[..., block(p) * w : (block(p) + 1) * w])


def make_mesh(n_data: Optional[int] = None, n_dict: int = 1,
              devices=None, upload: Optional[Callable] = None) -> Mesh:
    """The first n_data * n_dict of ``devices`` (default: every visible
    card) as a [n_data, n_dict] mesh; n_data defaults to as many as the
    devices fill.  ``devices`` may repeat a device; ``upload``: see
    Mesh.  Raises ValueError when there are too few devices or a card
    index is not visible."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else visible_devices("cuda"))
    if n_data is None:
        n_data = len(devices) // n_dict
    if n_data < 1 or n_data * n_dict > len(devices):
        raise ValueError(f"need {n_data}x{n_dict} devices, have "
                         f"{len(devices)}")
    devices = devices[: n_data * n_dict]
    n_cards = torch.cuda.device_count()
    for i, d in enumerate(devices):
        if d.type != "cuda":
            continue
        if d.index is None:  # "cuda": the current card
            d = devices[i] = torch.device("cuda", torch.cuda.current_device())
        if d.index >= n_cards:
            raise ValueError(f"{d} is not visible ({n_cards} CUDA devices)")
    return Mesh(devices, n_data, n_dict, upload)
