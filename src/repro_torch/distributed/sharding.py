"""Logical-axis sharding rules: DP / TP / SP / EP / FSDP on a device mesh —
the port of the reference's `distributed/sharding.py`.

Mesh axes: single-pod ("data", "model"); multi-pod ("pod", "data",
"model") (`launch/mesh.py`).

  * DP       batch over ("pod","data")
  * TP       heads / d_ff / vocab over "model" (Megatron)
  * SP       block-boundary activations: seq over "model" (Megatron-SP)
  * EP       MoE expert dim over "model" (`models/moe.moe_apply_ep`)
  * FSDP     parameter + optimizer fan-in dim over the data axes (ZeRO-3)

Every rule degrades gracefully: an axis is only applied when the dim is
divisible by the mesh axis size, else that dim is replicated.

The rules are pure functions of path names, shapes and mesh axis sizes.
A spec is a plain tuple with one entry per tensor dim: an axis name, a
tuple of axis names, or None (the reference's `PartitionSpec`).  They read
a mesh only through `mesh_dim_names` and `shape`, so they take a
`torch.distributed.device_mesh.DeviceMesh` or an `AbstractMesh` (names and
sizes, no devices).  `placements(spec, mesh)` turns a spec into DTensor
placements; `shard(x, names)`, the callback `make_shard_fn` returns, is the
counterpart of `with_sharding_constraint`: it redistributes a DTensor to
the spec's placements.  `local_call` runs a function on local shards (the
counterpart of `shard_map`); the models run every hand-written kernel
through it, so a DTensor never reaches a kernel wrapper.

The reference's single-controller scene mesh (`make_scene_mesh`,
`shard_over_scenes`) becomes a list of local devices with the leading
scene axis split across them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


class AbstractMesh(NamedTuple):
    """Axis sizes and names of a mesh with no devices behind it (the rules
    read nothing else)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    mesh: Any
    fsdp: bool = False            # shard params over the data axes (ZeRO-3)
    seq_parallel: bool = True     # Megatron-SP at block boundaries
    shard_seq_over_data: bool = False  # long-context decode (batch < data)
    # decode KV caches whose head dim can't shard over 'model' shard their
    # SEQ dim over 'model' instead
    kv_seq_over_model: bool = True

    @property
    def axes(self) -> dict:
        return mesh_axes(self.mesh)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axes)

    @property
    def n_data(self) -> int:
        return int(math.prod(self.axes[a] for a in self.data_axes))

    @property
    def n_model(self) -> int:
        return int(self.axes["model"])

    @property
    def data_spec(self):
        """The data axes as one spec entry: a name, a tuple, or None."""
        d = self.data_axes
        return d if len(d) > 1 else (d[0] if d else None)


def divides(n: Optional[int], m: int) -> bool:
    """m shards n: n is known, a multiple of m, and at least m."""
    return n is not None and n % m == 0 and n >= m


def axis_names(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(axes: dict, entry) -> int:
    return int(math.prod(axes[a] for a in axis_names(entry)))


def _maybe(axes: dict, dim: int, entry):
    """Apply `entry` to a dim only if divisible; else replicate."""
    return entry if divides(dim, _axis_size(axes, entry)) else None


# ---------------------------------------------------------------------------
# activation rules (the `shard` callback threaded through model code)
# ---------------------------------------------------------------------------

def activation_spec(sc: ShardingConfig, shape, names) -> Spec:
    """The spec the reference's shard callback constrains an activation of
    `shape` with logical dim `names` to."""
    axes, data = sc.axes, sc.data_spec
    dims = dict(zip(names, shape))
    batch = dims.get("batch")
    spec: list = [None] * len(names)
    for i, nm in enumerate(names):
        d = shape[i]
        if nm == "batch":
            spec[i] = _maybe(axes, d, data)
        elif nm == "seq_full":
            pass   # explicit SP gather point
        elif nm == "seq":
            if names[-1] == "d_model" and sc.seq_parallel:
                spec[i] = _maybe(axes, d, "model")
            elif sc.shard_seq_over_data and not divides(batch, sc.n_data):
                spec[i] = _maybe(axes, d, data)
        elif nm in ("heads", "kv_heads", "d_ff", "d_inner", "vocab"):
            if not (names[-1] == "d_model" and sc.seq_parallel
                    and nm != "vocab"):
                spec[i] = _maybe(axes, d, "model")
        # d_model / head_dim stay replicated
    # never shard the same mesh axis twice
    used: set = set()
    for i, s in enumerate(spec):
        if any(a in used for a in axis_names(s)):
            spec[i] = None
        used.update(axis_names(s))
    return tuple(spec)


class Shard(NamedTuple):
    """The sharding callback the model code takes as `shard`, the
    counterpart of the reference's: `shard(x, names)` redistributes x to
    `activation_spec` on the config's mesh.  `sc` is that config (None:
    the identity); under it the layers run their kernels on local shards."""
    sc: Optional[ShardingConfig] = None

    def __call__(self, x, names):
        if self.sc is None:
            return x
        return constrain(x, activation_spec(self.sc, tuple(x.shape), names),
                         self.sc.mesh)

    def local(self, fn, args, names, out_names, sizes: dict):
        """`fn(*args)` -> a tuple of tensors, under the config on each
        rank's local shards (`local_call`); without one, fn(*args).  The
        dims of each argument and output are named: "batch" splits over
        the data axes and "d_inner" over "model" where `sizes` of that
        name divides them, every other dim stays whole (a scan needs its
        whole sequence).  An argument replicated along an axis that splits
        the work takes its gradient there as a partial sum."""
        if self.sc is None:
            return fn(*args)
        sc = self.sc
        on = {"batch": _maybe(sc.axes, sizes.get("batch"), sc.data_spec),
              "d_inner": _maybe(sc.axes, sizes.get("d_inner"), "model")}

        def spec(dims):
            return tuple(on.get(n) for n in dims)
        return tuple(local_call(
            fn, args, [spec(n) for n in names], [spec(n) for n in out_names],
            sc.mesh, grad_partial=axis_names(on["batch"]) +
            axis_names(on["d_inner"])))


identity_shard = Shard()


def make_shard_fn(sc: ShardingConfig) -> Shard:
    """shard(x, names) -> x redistributed to `activation_spec` on the
    config's mesh."""
    return Shard(sc)


# ---------------------------------------------------------------------------
# parameter rules (path-name dispatch)
# ---------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "up", "wx", "wif",
                 "in_proj", "dt_proj", "lm_head", "head"}
_ROW_PARALLEL = {"wo", "down", "out_proj", "proj", "x_proj"}
_NORM_LEAVES = {"scale"}


def param_spec(path: Sequence[str], shape, sc: ShardingConfig,
               stacked: bool = False) -> Spec:
    """Sharding spec for one parameter leaf, identified by its path (the
    tree's keys from the root)."""
    axes = sc.axes
    names = [str(n) for n in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    fsdp = sc.data_spec if sc.fsdp and sc.data_axes else None

    core = list(shape[1:]) if stacked else list(shape)
    spec: list = [None] * len(core)

    def col2d():    # (fan_in, fan_out) -> (fsdp, model)
        spec[0] = _maybe(axes, core[0], fsdp)
        spec[1] = _maybe(axes, core[1], "model")

    def row2d():    # (fan_in, fan_out) -> (model, fsdp)
        spec[0] = _maybe(axes, core[0], "model")
        spec[1] = _maybe(axes, core[1], fsdp)

    if leaf == "emb":                       # (V, D): vocab over model
        spec[0] = _maybe(axes, core[0], "model")
        spec[1] = _maybe(axes, core[1], fsdp)
    elif leaf in _NORM_LEAVES or parent.startswith("norm") or \
            parent in ("n1", "n2", "final_norm", "enc_norm"):
        pass                                # replicated
    elif leaf in ("w_in", "w_gate"):        # (E, D, F)
        spec[0] = _maybe(axes, core[0], "model")
        if spec[0] is None:
            spec[1] = _maybe(axes, core[1], fsdp)
            spec[2] = _maybe(axes, core[2], "model")
        else:
            spec[1] = _maybe(axes, core[1], fsdp)
    elif leaf == "w_out":                   # (E, F, D)
        spec[0] = _maybe(axes, core[0], "model")
        if spec[0] is None:
            spec[1] = _maybe(axes, core[1], "model")
            spec[2] = _maybe(axes, core[2], fsdp)
        else:
            spec[2] = _maybe(axes, core[2], fsdp)
    elif parent == "router":
        spec[0] = _maybe(axes, core[0], fsdp)
    elif leaf == "w" and len(core) == 2:
        if parent in _ROW_PARALLEL:
            row2d()
        else:                               # col-parallel default
            col2d()
    elif leaf == "b" and len(core) == 1:
        if parent in _COL_PARALLEL or parent not in _ROW_PARALLEL:
            spec[0] = _maybe(axes, core[0], "model")
    elif leaf == "conv_w":                  # (k, d_inner)
        spec[1] = _maybe(axes, core[1], "model")
    elif leaf in ("conv_b", "D"):           # (d_inner,)
        spec[0] = _maybe(axes, core[0], "model")
    elif leaf == "A_log":                   # (d_inner, N)
        spec[0] = _maybe(axes, core[0], "model")
    elif len(core) == 3 and leaf == "w":    # stacked conv-ish (K, Cin, Cout)
        spec[2] = _maybe(axes, core[2], "model")

    if stacked:
        spec = [None] + spec
    return tuple(spec)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """`fn(path, leaf)` over nested dicts / lists / NamedTuples; a path
    holds dict keys, NamedTuple field names and list indices as strings
    (the reference's `_path_names`)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def params_shardings(param_shapes, sc: ShardingConfig):
    """Tree of tensors (or shapes) -> tree of specs.  Anything under a
    'layers' / 'enc_layers' / 'dec_layers' subtree is stacked (leading
    body dim)."""
    def one(path, leaf):
        stacked = any(n.endswith("layers") for n in path)
        return param_spec(path, _shape(leaf), sc, stacked)
    return tree_map_with_path(one, as_tree(param_shapes))


# ---------------------------------------------------------------------------
# batch / decode-state rules
# ---------------------------------------------------------------------------

def batch_specs(batch_shapes, sc: ShardingConfig):
    data = sc.data_spec

    def one(path, leaf):
        shape = _shape(leaf)
        spec: list = [None] * len(shape)
        if len(shape) >= 1 and divides(shape[0], sc.n_data):
            spec[0] = data
        elif len(shape) >= 2 and sc.shard_seq_over_data:
            # long-context: batch too small, shard the seq dim instead
            if divides(shape[1], sc.n_data):
                spec[1] = data
        return tuple(spec)
    return tree_map_with_path(one, batch_shapes)


def state_specs(state_shapes, sc: ShardingConfig):
    """Decode-state tree: KV caches (nb, B, S, H, hd), SSM states, etc."""
    axes, data = sc.axes, sc.data_spec

    def one(names, leaf):
        shape = _shape(leaf)
        spec: list = [None] * len(shape)
        batch_ok = len(shape) > 1 and divides(shape[1], sc.n_data)
        if "self_kv" in names or "cross" in names or \
                (len(shape) == 5 and names[-1] in ("k", "v")):
            # (nb, B, S, H, hd)
            if batch_ok:
                spec[1] = data
            elif divides(shape[2], sc.n_data):
                spec[2] = data            # flash-decoding: shard seq
            spec[3] = _maybe(axes, shape[3], "model")
            if spec[3] is None and spec[2] is None and \
                    sc.kv_seq_over_model and divides(shape[2], sc.n_model):
                # heads unshardable -> flash-decode over 'model'
                spec[2] = "model"
        elif names[-1] == "ssm":          # (nb, B, di, N)
            if batch_ok:
                spec[1] = data
            spec[2] = _maybe(axes, shape[2], "model")
        elif names[-1] == "conv":         # (nb, B, k-1, di)
            if batch_ok:
                spec[1] = data
            spec[3] = _maybe(axes, shape[3], "model")
        else:                             # mlstm / slstm scalar states
            if batch_ok:
                spec[1] = data
        return tuple(spec)
    return tree_map_with_path(one, state_shapes)


def replicated(sc: ShardingConfig) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """One DTensor placement per mesh dim: Shard(i) where tensor dim i's
    spec entry names that mesh axis, else Replicate.  A tuple entry
    ("pod", "data") shards its dim over both, in mesh-dim order.  A mesh
    axis of size 1 is left Replicate (the same layout; DTensor reshapes
    fewer shardings)."""
    from torch.distributed.tensor import Replicate, Shard
    dims, sizes = list(mesh.mesh_dim_names), mesh_axes(mesh)
    out: list = [Replicate()] * len(dims)
    for i, entry in enumerate(spec):
        for a in axis_names(entry):
            if sizes[a] > 1:
                out[dims.index(a)] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, spec: Spec, mesh):
    """x as a DTensor with `placements(spec, mesh)`.  A plain tensor is
    taken as the global value, the same on every rank (its shards are
    local slices, no exchange); pending partial sums are reduced first."""
    from torch.distributed.tensor import DTensor, Replicate
    target = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x = reduced(x)
    if tuple(x.placements) != tuple(target):
        x = x.redistribute(mesh, target)
    return x


def reduced(x):
    """x with its pending partial sums reduced (those mesh dims
    replicated); a plain tensor, or a DTensor with none, passes through."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def distribute(tree, specs, mesh):
    """A tree of global tensors (the same on every rank) placed by a tree
    of specs: each leaf becomes a DTensor holding only its local shard."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda x, s: constrain(x, s, mesh).detach(),
                    as_tree(tree), specs)


def gather(tree):
    """A tree of DTensors (or plain tensors) -> global plain tensors."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x,
                    as_tree(tree))


def as_tree(tree):
    """The nested dict of a ParamTree (any other tree passes through)."""
    from repro_torch.models.params import ParamTree
    return tree.tree() if isinstance(tree, ParamTree) else tree


def local_call(fn: Callable, args, in_specs, out_specs, mesh,
               grad_partial: Tuple[str, ...] = ()):
    """`fn(*local_args)` on each rank's local shards, the counterpart of
    `shard_map`: every tensor argument is redistributed to its spec
    (`None` for an argument that is not a tensor), `fn` sees plain local
    tensors, and its outputs (one spec each in a list, or one spec for a
    single output) come back as DTensors.  Differentiable: the gradient of
    an input is sharded as the input; over the mesh axes in
    `grad_partial`, along which `fn` does a different share of the work
    on each rank (its tokens are split there), the gradient of an input
    replicated along them is a partial sum."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    single = not isinstance(out_specs, list)
    outs = [out_specs] if single else out_specs
    out_pl = [placements(s, mesh) for s in outs]
    in_pl, grad_pl = [], []
    for s in in_specs:
        if s is None:
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(s, mesh)
        in_pl.append(pl)
        grad_pl.append([Partial() if not p.is_shard() and a in grad_partial
                        else p for p, a in zip(pl, mesh.mesh_dim_names)])
    args = [a if s is None or is_dtensor(a) else constrain(a, (), mesh)
            for a, s in zip(args, in_specs)]
    mapped = local_map(
        fn, out_placements=out_pl[0] if single else tuple(out_pl),
        in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
        device_mesh=mesh, redistribute_inputs=True)
    return mapped(*args)


def like(x, ref):
    """x (a plain global tensor) as a replicated DTensor on `ref`'s mesh
    when `ref` is a DTensor, so the two combine; else x (a DTensor x too)."""
    if is_dtensor(ref) and not is_dtensor(x):
        return constrain(x, (), ref.device_mesh)
    return x


def unshard_dim(x, dim: int, n: int):
    """x with dim `dim` gathered (replicated) when it is split into a
    number of shards that does not divide n; else x."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    split = [m for m, p in enumerate(x.placements) if p.is_shard(dim)]
    if n % math.prod(mesh.size(m) for m in split) == 0:
        return x
    return x.redistribute(mesh, [Replicate() if m in split else p
                                 for m, p in enumerate(x.placements)])


def gather_dim(x, dim: int):
    """x with dim `dim` replicated over every mesh dim that shards it (a
    plain tensor, or a DTensor not sharded there, passes through)."""
    if not is_dtensor(x) or not any(p.is_shard(dim) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in x.placements])


class _GatheredGrad(torch.autograd.Function):
    """Identity forward; the gradient gathered along `dim` (with `n`, only
    where its shards do not divide n: `unshard_dim`)."""

    @staticmethod
    def forward(ctx, y, dim, n):
        ctx.dim, ctx.n = dim, n
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if ctx.n is None:
            return gather_dim(g, ctx.dim), None, None
        return unshard_dim(g, ctx.dim, ctx.n), None, None


def gathered_grad(y, dim: int, n: Optional[int] = None):
    """y, whose gradient comes back with dim `dim` replicated (a DTensor's
    `gather_dim`); with `n`, only when it is split into a number of shards
    that does not divide n (`unshard_dim`: a gradient whose shards would
    cut the n heads a view splits the dim into).  A plain y passes
    through."""
    return _GatheredGrad.apply(y, dim, n) if is_dtensor(y) else y


def full(x):
    """The global value of a DTensor (a plain tensor passes through)."""
    return x.full_tensor() if is_dtensor(x) else x


def local_offsets(x) -> Tuple[int, ...]:
    """Where a DTensor's local shard starts in the global tensor, per dim
    (even shards; a dim sharded over several mesh dims nests them in mesh
    order)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    out = []
    for d, size in enumerate(x.shape):
        off = 0
        for m, p in enumerate(x.placements):
            if p.is_shard(d):
                size //= mesh.size(m)
                off += coord[m] * size
        out.append(off)
    return tuple(out)


def write_rows(cache, slot, rows):
    """cache[b, slot[b]] = rows[b] for every batch row b, in place: on a
    DTensor cache (B, S, ...) each rank writes the rows and slots its
    local shard holds (`rows` is the global (B, ...) value)."""
    b_all = torch.arange(rows.shape[0], device=rows.device)
    if not is_dtensor(cache):
        cache[b_all, slot] = rows
        return
    local = cache.to_local()
    ob, os_, *rest = local_offsets(cache)
    nb, ns = local.shape[0], local.shape[1]
    # the shard's batch rows are a fixed range; whether a row's slot lies in
    # the shard is a device value, so a row whose slot does not writes back
    # what its (clamped) slot holds: no shape depends on the data, and each
    # row writes one place
    idx = tuple(slice(o, o + n) for o, n in zip(rest, local.shape[2:]))
    mine = rows[(slice(ob, ob + nb),) + idx].to(local.dtype)
    at = slot[ob:ob + nb] - os_
    keep = ((at >= 0) & (at < ns)).reshape((-1,) + (1,) * (mine.dim() - 1))
    at = at.clamp(0, ns - 1)
    b_loc = b_all[:nb]
    local[b_loc, at] = torch.where(keep, mine, local[b_loc, at])


def write_into(dst, src):
    """dst[:src.shape] = src in place, src the global value; on a DTensor
    each rank writes the part of the window its local shard holds."""
    if not is_dtensor(dst):
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        return
    local = dst.to_local()
    d_idx, s_idx = [], []
    for o, n, m in zip(local_offsets(dst), local.shape, src.shape):
        lo, hi = max(o, 0), min(o + n, m)
        if hi <= lo:
            return
        d_idx.append(slice(lo - o, hi - o))
        s_idx.append(slice(lo, hi))
    local[tuple(d_idx)].copy_(src[tuple(s_idx)])


# ---------------------------------------------------------------------------
# scene-axis serving rules (continuous-batching point-cloud scheduler)
# ---------------------------------------------------------------------------

class SceneMesh(NamedTuple):
    """Local devices that split a batch's leading scene axis."""
    devices: Tuple[torch.device, ...]
    axis: str = "scene"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_scene_mesh(axis: str = "scene", devices=None) -> Optional[SceneMesh]:
    """The host's devices for scene-parallel serving: every CUDA device,
    or `devices`.  Returns None for fewer than two devices — the serve
    scheduler then runs the batched path directly, so the same code
    serves one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) < 2:
        return None
    return SceneMesh(devs, axis)


def shard_over_scenes(fn, mesh: SceneMesh, axis: str = "scene"):
    """Split a batched function over its leading scene axis.

    `fn(*args) -> out` takes arguments batched along dim 0 (the scene
    axis): tensors, or lists with one entry a scene (each entry a tree of
    tensors); it returns a tensor batched the same way.  `fn` may be one
    function or one a device.  Device i runs it on its B/n consecutive
    scenes (moved there), and the outputs are concatenated on the first
    device.  The scene axis of every argument must be divisible by the
    device count — the scheduler pads micro-batches to a scene count that
    is a multiple of it.  All shards are dispatched before any is
    collected, so the devices run concurrently.
    """
    from repro_torch.models.params import tree_map
    n = mesh.size
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * n

    def move(x, dev):
        return x.to(dev, non_blocking=True) \
            if isinstance(x, torch.Tensor) else x

    def sharded(*args):
        b = len(args[0])
        if b % n:
            raise ValueError(f"scene axis {b} is not divisible by the "
                             f"{n} devices of the '{axis}' mesh")
        per = b // n
        outs = []
        for f, i, dev in zip(fns, range(n), mesh.devices):
            part = [tree_map(lambda x: move(x, dev), a[i * per:(i + 1) * per])
                    for a in args]
            outs.append(f(*part))
        first = mesh.devices[0]
        return torch.cat([move(o, first) for o in outs])

    return sharded
