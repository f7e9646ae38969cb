"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) on a torch
`DeviceMesh` (the port of `repro.parallel.sharding`).

Models annotate activations with *logical* axis names; the active
`AxisRules` maps logical names to mesh axes.  Parameters get specs from
their name and shape through `param_spec`.  Everything is a no-op when no
mesh is active, so the same model code runs on one card and in the fake
world of the dry-run.

A spec is a tuple with one entry per tensor dim, each None, a mesh-axis name
or a tuple of them: the entries of the reference's `PartitionSpec`, so the
two compare one for one.  `placements` turns a spec into DTensor placements,
one per mesh dim: a tensor dim over ("pod", "data") is `Shard(d)` on both
mesh dims, pod major -- the layout `P(("pod", "data"))` has.

Every function that reads a mesh takes a `DeviceMesh` or, for the pure spec
logic, a dict {axis name: size} in mesh order (`axis_sizes`), so specs of
the 256- and 512-device meshes are computed without a process group.

Baseline strategy:
  batch    -> ("pod", "data")     pure DP across pods, DP within pod
  d_ff / heads / vocab / experts -> "model"   (TP / EP)
  fsdp     -> "data"              parameters additionally sharded over data
  seq      -> optionally "model"  (sequence parallelism for long contexts)
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch


@dataclasses.dataclass(frozen=True)
class AxisRules:
    batch: tuple | str | None = ("pod", "data")
    seq: str | None = None            # "model" => sequence parallelism
    dmodel: str | None = None
    heads: str | None = "model"
    ff: str | None = "model"
    vocab: str | None = "model"
    expert: str | None = "model"
    fsdp: str | None = "data"         # param dim sharded over data axis
    kv_len: str | None = None         # decode: KV-cache length axis

    def resolve(self, name: str | None):
        if name is None:
            return None
        return getattr(self, name)


_STATE = threading.local()


def _get():
    if not hasattr(_STATE, "mesh"):
        _STATE.mesh, _STATE.rules = None, AxisRules()
    return _STATE


@contextlib.contextmanager
def use_mesh(mesh, rules: AxisRules | None = None):
    """Make `mesh` and `rules` current.  Under a mesh a plain tensor that
    meets a DTensor in an op is a replicated constant (DTensor's
    `implicit_replication`), as a constant is under the reference's
    partitioner."""
    st = _get()
    prev = (st.mesh, st.rules)
    st.mesh = mesh
    st.rules = rules or AxisRules()
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            with implicit_replication():
                yield
    finally:
        st.mesh, st.rules = prev


def checkpoint_context():
    """`context_fn` for `torch.utils.checkpoint`: the recompute sees the
    forward's mesh and rules.  The state is per thread, and autograd runs a
    CUDA backward -- the recompute with it -- on a thread of its own."""
    st = _get()
    return contextlib.nullcontext(), use_mesh(st.mesh, st.rules)


def current_mesh():
    return _get().mesh


def current_rules() -> AxisRules:
    return _get().rules


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, of a `DeviceMesh` or such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _filter_spec(mesh, spec_axes: tuple) -> tuple:
    """Drop axes not present in the mesh (e.g. 'pod' on the single-pod mesh),
    and de-duplicate mesh axes across dims with rightmost-dim priority (under
    sequence parallelism both 'seq' and 'ff'/'heads' may map to 'model'; the
    inner/TP dim wins)."""
    names = set(axis_sizes(mesh))

    def ok(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in names)
            return kept if kept else None
        return a if a in names else None

    axes = [ok(a) for a in spec_axes]
    used: set = set()
    for i in range(len(axes) - 1, -1, -1):  # rightmost wins
        a = axes[i]
        if a is None:
            continue
        flat = tuple(a) if isinstance(a, tuple) else (a,)
        if any(x in used for x in flat):
            kept = tuple(x for x in flat if x not in used)
            axes[i] = kept if kept else None
            flat = kept
        used.update(flat)
    return tuple(axes)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: `Shard(d)` on every
    mesh dim tensor dim d names, `Replicate()` on the rest.  A tensor dim
    over several mesh dims must name them in mesh order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(axis_sizes(mesh))
    out = [Replicate()] * len(order)
    for d, a in enumerate(spec):
        if a is None:
            continue
        flat = tuple(a) if isinstance(a, (tuple, list)) else (a,)
        idx = [order.index(x) for x in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names mesh axes {flat} "
                             f"out of mesh order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_spec(mesh, rules: AxisRules, logical_axes) -> tuple:
    """The spec `act` constrains to: logical names resolved, filtered."""
    return _filter_spec(mesh, tuple(rules.resolve(a) for a in logical_axes))


def act(x, *logical_axes):
    """Constrain an activation's sharding by logical axis names (None =
    replicated): `x.redistribute` onto the active mesh for a DTensor, the
    identity without a mesh or for a plain tensor."""
    st = _get()
    if st.mesh is None or not is_dtensor(x):
        return x
    spec = logical_spec(st.mesh, st.rules, logical_axes)
    return x.redistribute(st.mesh, placements(spec, st.mesh))


def constant(t, like, *logical_axes):
    """`t`, a tensor every rank computes alike (positions, masks), laid out
    by logical axes as a DTensor when `like` is one under the active mesh
    (each rank keeps its own chunk: no communication); `t` otherwise."""
    st = _get()
    if st.mesh is None or not is_dtensor(like):
        return t
    from torch.distributed.tensor import distribute_tensor

    spec = logical_spec(st.mesh, st.rules, logical_axes)
    return distribute_tensor(t, st.mesh, placements(spec, st.mesh),
                             src_data_rank=None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def batch_axes_for(size: int):
    """Mesh axes for a batch dim of `size` under the current rules, or None
    when the size doesn't divide the axes (e.g. global_batch=1 long-context)."""
    st = _get()
    if st.mesh is None:
        return None
    dp = _filter_spec(st.mesh, (st.rules.batch,))[0]
    if dp is None:
        return None
    axes = dp if isinstance(dp, (tuple, list)) else (dp,)
    sizes = axis_sizes(st.mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    return dp if total and size % total == 0 else None


# --- parameter specs -------------------------------------------------------------

def _divides(mesh, axis, size: int) -> bool:
    if axis is None:
        return False
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        total = 1
        for a in axis:
            if a in sizes:
                total *= sizes[a]
        return total > 0 and size % total == 0
    return axis in sizes and size % sizes[axis] == 0


def param_spec(path: str, shape: tuple, mesh, rules: AxisRules,
               stacked: bool = True) -> tuple:
    """Spec of one parameter leaf.

    `path` is the '/'-joined tree path; `stacked` params carry a leading
    layer-stack dim (never sharded).  Policy: the tensor-parallel dim follows
    the leaf's role (ff/heads/vocab/expert), the other large dim is FSDP-sharded
    over the data axis when divisible.
    """
    dims: list = [None] * len(shape)
    start = 1 if stacked and len(shape) > 1 else 0
    body = list(range(start, len(shape)))
    if not body:
        return tuple(dims)

    lname = path.lower()

    def assign(idx: int, logical: str) -> bool:
        ax = rules.resolve(logical)
        if ax is not None and dims[idx] is None and _divides(mesh, ax, shape[idx]):
            dims[idx] = ax
            return True
        return False

    # Role-specific TP axis.
    if "embed" in lname or "unembed" in lname or "lm_head" in lname:
        assign(body[0], "vocab")                  # (V, D) vocab-sharded
    elif "expert" in lname and len(body) >= 2:
        assign(body[0], "expert")                 # (E, ...) expert-parallel
        # FSDP the reduction dim of the expert matrices.
        if len(body) >= 3:
            assign(body[1], "fsdp")
    elif len(body) >= 2:
        assign(body[-1], "ff" if ("mlp" in lname or "ffn" in lname or "up" in lname
                                  or "gate" in lname) else "heads")
        assign(body[0], "fsdp")
    elif len(body) == 1 and shape[body[0]] >= 1024:
        assign(body[0], "fsdp")
    return tuple(dims)


def port_param_spec(name: str, shape: tuple, mesh, rules: AxisRules,
                    period: int = 1) -> tuple:
    """Spec of one of the port's parameters, by its state-dict name.  The
    reference stacks a layer's leaves over super-blocks and applies
    `param_spec` to every leaf with `stacked=True`; the port holds one
    tensor a layer.  So a leaf of a layer stack (`convert.is_stacked`) gets
    the reference leaf's spec -- a unit stack dim put in front, then
    dropped -- and any other leaf the spec the reference gives its own
    shape.  The path is the reference's (`convert.reference_path`)."""
    from repro_torch.convert import is_stacked, reference_path

    path = reference_path(name, period)
    if is_stacked(name):
        return param_spec(path, (1, *shape), mesh, rules)[1:]
    return param_spec(path, tuple(shape), mesh, rules)


def tree_param_specs(shapes: dict, mesh, rules: AxisRules,
                     period: int = 1) -> dict:
    """{name: spec} of a model's parameters ({name: shape or tensor})."""
    return {k: port_param_spec(k, tuple(v.shape) if hasattr(v, "shape")
                               else tuple(v), mesh, rules, period)
            for k, v in shapes.items()}


# --- local regions (the reference's shard_map) ----------------------------------

def is_sharded(*tensors) -> bool:
    """Whether a mesh is active and every tensor is a DTensor: the
    condition of the models' mesh branches."""
    return current_mesh() is not None and all(is_dtensor(t) for t in tensors)


def spec_of(t) -> tuple:
    """The spec of a DTensor's placements (the inverse of `placements`;
    a Partial placement is not a layout and raises)."""
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names
    dims: list = [[] for _ in range(t.dim())]
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"spec_of: placement {pl} is not a layout")
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                 for d in dims)


def shard_axis(t, dim: int):
    """The one mesh axis a DTensor's dim is sharded over, or None."""
    a = spec_of(t)[dim]
    if isinstance(a, tuple):
        raise ValueError(f"dim {dim} is sharded over several axes {a}")
    return a


def gather_fsdp(tree):
    """Parameters (a tensor or nested dicts of them) gathered over the
    rules' FSDP axis, keeping their tensor-parallel shards: FSDP's gather
    before use.  Without it DTensor may contract over a weight dim sharded
    on the data axis and gather the (much larger) activations instead; its
    backward reduce-scatters the gradients.  The identity without a mesh,
    without an FSDP axis, or for a plain tensor."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    st = _get()
    if st.mesh is None or st.rules.fsdp is None or not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate, Shard

    names = tree.device_mesh.mesh_dim_names
    pl = [Replicate() if isinstance(p, Shard) and n == st.rules.fsdp else p
          for n, p in zip(names, tree.placements)]
    if pl == list(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, pl)


def axis_index(axis: str) -> int:
    """This rank's coordinate on a mesh axis of the active mesh."""
    return current_mesh().get_local_rank(axis)


def _group(axis: str):
    mesh = current_mesh()
    return (mesh, list(mesh.mesh_dim_names).index(axis))


def _wait(t):
    from torch.distributed import _functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a mesh axis inside a local region; its backward is the
    identity (`shard_map`'s gradient rule below)."""

    @staticmethod
    def forward(ctx, x, axis: str):
        from torch.distributed import _functional_collectives as funcol

        return _wait(funcol.all_reduce(x, "sum", _group(axis)))

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(t, axis: str):
    """psum over `axis` of the active mesh, inside `shard_map`."""
    return _AllReduceSum.apply(t, axis)


def all_reduce_max(t, axis: str):
    """pmax over `axis` with no gradient (the reference's `pmax_const`: its
    tangent is zero), inside `shard_map`."""
    from torch.distributed import _functional_collectives as funcol

    return _wait(funcol.all_reduce(t.detach(), "max", _group(axis)))


def shard_map(fn, args: tuple, in_specs: tuple, out_specs: tuple,
              out_shapes: tuple, same_on: tuple = ()):
    """Run `fn` on the local chunks of DTensor `args` and wrap its outputs
    (a tensor or a tuple) as DTensors: the reference's `shard_map` on the
    active mesh.  Each arg is redistributed to its spec (None: not a
    DTensor, passed as is); each output gets its spec and its global shape
    from `out_shapes` (explicit, so uneven shards keep their true size).

    Gradients: an input's local gradient on a mesh axis it is replicated
    over is taken as a partial sum over that axis.  That is exact when every
    rank's output along the axis is a summand of the result (combined with
    `all_reduce_sum`, whose backward is the identity) or a slice of it of
    its own.  Along the axes named in `same_on` every rank computes the same
    outputs from the same inputs, and its local gradient is the whole
    gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = current_mesh()
    names = list(axis_sizes(mesh))
    local = []
    for a, spec in zip(args, in_specs):
        if spec is None:
            local.append(a)
            continue
        pl = placements(spec, mesh)
        grad_pl = [Partial() if isinstance(p, Replicate)
                   and names[i] not in same_on else p
                   for i, p in enumerate(pl)]
        local.append(a.redistribute(mesh, pl).to_local(
            grad_placements=grad_pl))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = []
    for o, spec, shape in zip(outs, out_specs, out_shapes):
        shape = torch.Size(shape)
        stride, acc = [], 1
        for n in reversed(shape):
            stride.insert(0, acc)
            acc *= max(n, 1)
        wrapped.append(DTensor.from_local(o, mesh, placements(spec, mesh),
                                          run_check=False, shape=shape,
                                          stride=tuple(stride)))
    return wrapped[0] if single else tuple(wrapped)
