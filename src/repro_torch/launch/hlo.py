"""Op analysis of a traced step: collective traffic, FLOPs, bytes and an op
census, per rank.

The twin of ``repro.launch.hlo``, which parses a compiled per-device HLO
module.  The port has no compiled module: :class:`Recorder` records the
step as it runs (on meta tensors in the dry run, every model kernel
reached through its custom op's fake; on the card for real), one
:class:`Op` a dispatched op, and :func:`collective_bytes`,
:func:`op_census` and :func:`analyze` read that trace where the
reference reads HLO text.

**Per-rank counts.**  A ``TorchDispatchMode`` sees an op on DTensors
before DTensor runs it, with the global shapes: ``FlopCounterMode``
counts a ``[256, 4096] @ [4096, 8192]`` product sharded over a 16 x 16
mesh as the global product's 17.2 GFLOPs, whatever the mesh.  The
reference's ``flops`` are per device, since it analyses the per-device
module.  The recorder therefore returns ``NotImplemented`` for every op
with a DTensor operand, as ``CommDebugMode`` does: DTensor runs first and
the recorder sees what it desugars into, the local op on this rank's
shards and the functional collectives that redistribute them (the ops
that DTensor's sharding propagation runs on fake tensors of the global
shapes, under a ``FakeTensorMode``, are not recorded).  Every
record is one rank's, so ``flops`` is per rank: the global product above
counts as its ``[16, 4096] @ [4096, 512]`` shard (1/256 of it) after an
all-gather, and a product that DTensor replicates over an axis counts in
full on each rank, as it is computed there.  Ops inside ``local_map``
regions are on local tensors already.

**Conventions, the reference's.**  ``flops`` counts products only (every
op with a formula in ``torch.utils.flop_counter``'s registry: ``mm``,
``bmm``, ``addmm``, convolutions, ... and the FLOP formulas that the
kernels' custom ops register); elementwise work is not counted (the MFU
convention).  Collective bytes are result bytes, the standard proxy for
per-device link traffic: a ring all-gather moves (n-1)/n of its result
per device; the raw sum is reported and the ring factor belongs to the
roofline.  Views move no bytes and are counted in the census only.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# functional-collective op names (``_c10d_functional``, and DTensor's own
# ``_dtensor.shard_dim_alltoall``) -> the kind
_COLLECTIVE_OPS = (("all_gather", "all-gather"),
                   ("reduce_scatter", "reduce-scatter"),
                   ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                   ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                   ("broadcast", "collective-permute"),
                   ("permute", "collective-permute"))
_NO_TRAFFIC = ("wait_tensor",)
# ops that move data and are counted in bytes_min, as the reference
# counts copy / dynamic-slice / dynamic-update-slice
COPIES = frozenset({
    "aten.copy_", "aten._to_copy", "aten.clone", "aten.cat",
    "aten.index", "aten.index_put", "aten.index_put_", "aten.index_select",
    "aten.gather", "aten.scatter", "aten.slice_scatter",
    "aten.select_scatter", "aten.embedding", "aten.repeat_interleave",
    "aten.new_empty_strided"})


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched op on one rank: ``kind`` is ``"product"`` (FLOPs
    counted), ``"kernel"`` (a ``repro_torch::`` custom op), ``"collective"``
    (``collective`` names which), ``"copy"``, ``"view"`` or ``"other"``."""

    name: str
    kind: str
    flops: int = 0
    operand_bytes: int = 0
    result_bytes: int = 0
    collective: str | None = None


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested dicts / lists / tuples and modules (their
    parameters and buffers), each DTensor as its local shard."""
    if isinstance(tree, torch.nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_name(func) -> str:
    """``aten.mm``, ``repro_torch.flash_attention``, ..."""
    return str(func._overloadpacket)


def _collective(name: str) -> str | None:
    if "c10d" not in name and "_dtensor" not in name:
        return None
    for key, kind in _COLLECTIVE_OPS:
        if key in name:
            return kind
    return None


def classify(func, args, kwargs, out) -> Op:
    """The :class:`Op` record of ``func(*args, **kwargs) -> out``."""
    name = op_name(func)
    packet = func._overloadpacket
    operand, result = _bytes((args, kwargs)), _bytes(out)
    if packet in flop_counter.flop_registry:
        flops = int(flop_counter.flop_registry[packet](
            *args, **(kwargs or {}), out_val=out))
        kind = "kernel" if name.startswith("repro_torch.") else "product"
        return Op(name, kind, flops, operand, result)
    if name.startswith("repro_torch."):
        return Op(name, "kernel", 0, operand, result)
    coll = _collective(name)
    if coll is not None:
        return Op(name, "collective", 0, operand, result, coll)
    if func.is_view or any(n in name for n in _NO_TRAFFIC):
        return Op(name, "view")
    return Op(name, "copy" if name in COPIES else "other", 0, operand,
              result)


class Recorder(TorchDispatchMode):
    """Records every op below DTensor (see the module docstring) as an
    :class:`Op` in :attr:`trace`, and the live bytes of the storages that
    those ops create: :attr:`peak` is their high-water mark, counted on
    top of the storages handed to :meth:`hold` (the step's arguments,
    this rank's local shards).  A storage is live until its last tensor
    goes, as on the card's allocator, before its rounding."""

    def __init__(self):
        super().__init__()
        self.trace: list[Op] = []
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}
        self._held: set[int] = set()

    # -- live bytes --------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors not yet counted;
        returns their bytes."""
        added = 0
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            weakref.finalize(st, self._free, key)
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def hold(self, tree) -> int:
        """Count ``tree``'s tensors as live (the step's arguments: on a
        mesh, this rank's local shards); returns their bytes.  A shard
        counts its own elements, not its storage's: a meta shard cut from
        a global meta tensor is a view of the global storage."""
        added, ids = 0, set()
        for t in tensors(tree):
            if id(t) in ids:
                continue
            ids.add(id(t))
            st = t.untyped_storage()
            n = t.numel() * t.element_size()
            self._held.add(st._cdata)
            if st._cdata not in self._seen:
                self._seen[st._cdata] = 0
                weakref.finalize(st, self._free, st._cdata)
            self._seen[st._cdata] += n
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def bytes_of(self, tree) -> int:
        """Bytes of ``tree``'s storages that :meth:`hold` did not count
        (a step's outputs that are not its arguments)."""
        out, seen = 0, set()
        for t in tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in seen and st._cdata not in self._held:
                seen.add(st._cdata)
                out += st.nbytes()
        return out

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar it first
        out = func(*args, **(kwargs or {}))
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out       # DTensor's sharding propagation, on global shapes
        self.trace.append(classify(func, args, kwargs, out))
        self._track(out)
        return out


def collective_bytes(trace: list[Op]) -> dict[str, int]:
    """Result bytes by collective kind, summed over the trace."""
    out: dict[str, int] = collections.defaultdict(int)
    for op in trace:
        if op.kind == "collective":
            out[op.collective] += op.result_bytes
    return dict(out)


def collective_counts(trace: list[Op]) -> dict[str, int]:
    """Calls by collective kind."""
    return dict(collections.Counter(op.collective for op in trace
                                    if op.kind == "collective"))


def op_census(trace: list[Op]) -> dict[str, int]:
    """Calls by op name (``aten.mm``, ``repro_torch.flash_attention``):
    spots recompute, copies between sharded ops, and so on."""
    return dict(collections.Counter(op.name for op in trace))


def analyze(trace: list[Op]) -> dict:
    """Per-rank cost of a trace: ``flops`` (products and kernels),
    ``collectives`` (bytes by kind), ``collective_counts`` and two traffic
    bounds:

    * ``bytes_min``: operands and results of products, kernels,
      collectives and copies; elementwise chains are taken as fused away,
      the optimistic bound for a roofline's memory term;
    * ``bytes_max``: every op's operands and results (views excluded), as
      eager PyTorch runs them, one pass over memory an op."""
    flops = sum(op.flops for op in trace)
    moved = [op.operand_bytes + op.result_bytes for op in trace]
    bmin = sum(b for op, b in zip(trace, moved) if op.kind in
               ("product", "kernel", "collective", "copy"))
    return {"flops": float(flops), "bytes_min": float(bmin),
            "bytes_max": float(sum(moved)),
            "collectives": collective_bytes(trace),
            "collective_counts": collective_counts(trace)}
