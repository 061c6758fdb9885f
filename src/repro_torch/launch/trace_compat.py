"""The torch internals the dry-run's trace rests on, in one place.

``repro_torch.launch.dryrun`` traces a step as DTensors over meta
shards on a fake process group and counts the local ops. Torch has no
public API for four of the things that takes:

- the store of a fake process group (``FakeStore``, from
  ``torch.testing._internal.distributed.fake_pg``);
- a dispatch mode that sees every op on the local shards
  (``TorchDispatchMode``, from ``torch.utils._python_dispatch``);
- parameters with shapes and dtypes and no storage (``FakeTensorMode``
  and ``FakeTensor``, from ``torch._subclasses.fake_tensor``);
- the identity and the lifetime of a tensor's storage: torch keeps one
  Python object a storage for as long as the storage lives, so
  :func:`storage_of` is that object and a weak reference to it ends
  when the storage is freed, by whichever tensor held it last.

The trace is tested on torch 2.11 and 2.13 (``tests/test_torch_dryrun.py``
holds each helper here); :func:`check_version` refuses older versions.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: F401

MIN_VERSION = (2, 11)


def torch_version() -> tuple:
    return tuple(int(x) for x in torch.__version__.split("+")[0]
                 .split(".")[:2])


def check_version() -> None:
    if torch_version() < MIN_VERSION:
        raise RuntimeError(f"the dry-run needs torch >= "
                           f"{'.'.join(map(str, MIN_VERSION))}, this is "
                           f"{torch.__version__}")


def fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def fake_tensor_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def storage_of(t: torch.Tensor):
    """The storage ``t`` views, the same object for every tensor on it."""
    return t.untyped_storage()
