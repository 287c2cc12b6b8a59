"""Private torch names that moved between releases, looked up in one place
— the counterpart of the reference's `compat.py`.

The dry run (`launch/dryrun.py`) and the kernel wrappers need names that
torch keeps outside its public API.  Each is looked up, on first use, in
every module where a release has kept it; a name no module has raises
ImportError with the torch version.  There is no stand-in:

  * `FakeStore` — the store of the "fake" process-group backend, whose
    collectives move nothing (the dry run's 256- and 512-rank worlds);
  * `MemTracker` — per-device memory of the tensors a dispatch mode sees,
    fake tensors included (the dry run's peak bytes per device);
  * `register_flop_formula` — the FLOP formula of an op, read by
    `FlopCounterMode` and by the dry run's counter (the `repro_torch::`
    kernel ops register theirs);
  * `flop_registry` — the formulas by op;
  * `active_fake_mode` — the innermost `FakeTensorMode` in effect (DTensor
    infers an op's output shapes under a fake mode of its own; the dry
    run's counter tells those ops from the step's by it, as `MemTracker`
    does);
  * `_current_autograd_node` — the autograd node a backward is running
    (`costmode.weight` reads the weight a counted loop trip put on it);
  * `fake_safe_dtensor()` — two DTensor methods run with the step's fake
    mode unset: `_StridedShard.local_shard_size_and_offset` computes a
    shard's size and offsets from a small index tensor, which would be
    fake (and `.tolist()` on it raises); `ShardingPropagator.
    _propagate_tensor_meta_non_cached` infers an op's output shape by
    running it at global sizes under the ambient fake mode, which would
    make those runs look like the step's own ops to a counter or a
    `MemTracker`.  Unset, the first gets real integers and the second a
    fake mode of its own, which both tell apart (`active_fake_mode`).

The reference's shims and what takes their place in the port:

  * `CompilerParams` (Pallas TPU compiler parameters): none; the port's
    kernels are CUDA C++ built by nvcc with the flags of `kernels/build.py`;
  * `pcast_varying` (shard_map's varying-manual-axes types): none; torch
    has no such type system, and `local_map` takes placements;
  * `axis_size`: `DeviceMesh.size(dim)`, or `distributed.sharding.mesh_axes`;
  * `shard_map`: `distributed.sharding.local_call` (`local_map`).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

_WHERE = {
    "FakeStore": ("torch.testing._internal.distributed.fake_pg",),
    "MemTracker": ("torch.distributed._tools.mem_tracker",
                   "torch.distributed._tools"),
    "register_flop_formula": ("torch.utils.flop_counter",),
    "flop_registry": ("torch.utils.flop_counter",),
    "_StridedShard": ("torch.distributed.tensor.placement_types",
                      "torch.distributed._tensor.placement_types"),
    "ShardingPropagator": ("torch.distributed.tensor._sharding_prop",
                           "torch.distributed._tensor._sharding_prop"),
    "unset_fake_temporarily": ("torch._subclasses.fake_tensor",),
    "active_fake_mode": ("torch._guards",),
    "_current_autograd_node": ("torch._C",),
}


def lookup(name: str):
    """`name` from the first module of `_WHERE[name]` that has it; raises
    ImportError naming the modules and the torch version."""
    for module in _WHERE[name]:
        try:
            found = importlib.import_module(module)
        except ImportError:
            continue
        if hasattr(found, name):
            return getattr(found, name)
    raise ImportError(f"{name} is in none of {_WHERE[name]} in torch "
                      f"{torch.__version__}")


def __getattr__(name: str):
    if name in _WHERE:
        return lookup(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@contextlib.contextmanager
def fake_safe_dtensor():
    """The two DTensor methods of the module docstring with the fake mode
    unset while they run; restored on exit."""
    unset = lookup("unset_fake_temporarily")
    patched = []
    for cls, name in ((lookup("_StridedShard"), "local_shard_size_and_offset"),
                      (lookup("ShardingPropagator"),
                       "_propagate_tensor_meta_non_cached")):
        orig = cls.__dict__.get(name)
        if orig is None:
            raise ImportError(f"{cls.__name__} has no {name} in torch "
                              f"{torch.__version__}")

        def unfaked(self, *args, _orig=orig, **kwargs):
            with unset():
                return _orig(self, *args, **kwargs)
        setattr(cls, name, unfaked)
        patched.append((cls, name, orig))
    try:
        yield
    finally:
        for cls, name, orig in patched:
            setattr(cls, name, orig)
