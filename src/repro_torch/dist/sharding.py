"""Sharding specs for the (data, model) meshes, and the blocks they give.

PyTorch counterpart of ``repro.dist.sharding``.  Every builder is a pure
function of the configuration, the mesh's shape (``axis_names``,
``shape[axis]``: a ``launch.mesh.Mesh`` or an ``AbstractMesh``) and the
leaves' shapes, and returns for each leaf a *spec*: a tuple with one entry
a dim, ``None`` (the dim is whole on every rank), an axis name or a tuple
of axis names (the dim is split over them, row-major), the entries of the
reference's ``PartitionSpec`` (``()`` is its ``P()``: every dim whole).
Where the reference returns a ``NamedSharding`` the port returns the spec.

Mesh contract: every mesh has a ``model`` axis (tensor / expert
parallelism, the intra-die dimension where the H-tree combines partial
sums) and one or more *data* axes (``data``, optionally a leading ``pod``)
over which batches, decode slots and FSDP-stored weights shard.

Param layout follows the Megatron split: column-parallel projections shard
their output dim over ``model`` and their input dim over the data axes
(FSDP); row-parallel projections the transpose.  Quantized ``*_q`` weights
shard like their float originals and their per-output-column scales
``*_s`` ride the output dim's axes.  MoE weights follow
:func:`moe_param_specs`: decode experts are *resident* (``ep2``,
``ep_data``, ``etp2``: tokens come to them), prefill uses ``ep`` / ``etp``
over ``model`` with ZeRO-3 storage over the data axes.

:func:`shard` cuts a rank's block out of a whole tensor by a spec,
:func:`unshard` gathers the whole back, :func:`reshard` moves a block from
one spec to another with the least gathering.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig

MODEL_AXIS = "model"

# column-parallel: output dim over `model`, input dim FSDP over data axes
_COL_PARALLEL = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b",
                 "w_up", "w_gate", "w_z", "w_x"}
# row-parallel: input dim over `model`, output dim FSDP over data axes
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}


def P(*entries) -> tuple:
    """A spec: the entries of the reference's ``PartitionSpec(*entries)``."""
    return tuple(entries)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def data_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis that is not the model axis (``pod``/``data``/...)."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def axes_size(mesh, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return _prod(mesh.shape[a] for a in axes)


def _fit(mesh, dim: int, axes):
    """``axes`` if they evenly tile ``dim``, else None (replicate)."""
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes:
        return None
    total = axes_size(mesh, axes)
    if dim % total == 0 and dim >= total:
        return axes if len(axes) > 1 else axes[0]
    return None


def replicated(mesh) -> tuple:
    return P()


def fit_spec(spec: tuple, shape, mesh) -> tuple:
    """``spec`` with the entries whose axes no longer tile their dim of
    ``shape`` dropped (the reference's ``opt_state_shardings._fit_spec``:
    the int8 moments' block scales collapse the last dim by 128)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        total = axes_size(mesh, e)
        out.append(e if (e is not None and dim % total == 0 and dim >= total) else None)
    return P(*out)


def split_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """Every axis (of size above 1) that splits some dim under ``spec``, in
    the mesh's order: the ranks of one group over them hold the leaf's
    blocks, the other axes hold copies."""
    used = {a for e in live(spec, mesh) for a in e}
    return tuple(a for a in mesh.axis_names if a in used)


def global_shape(t, spec: tuple, mesh) -> tuple[int, ...]:
    """The whole leaf's shape from a rank's block ``t`` under ``spec``."""
    lv = live(spec, mesh)
    return tuple(n * (axes_size(mesh, lv[d]) if d < len(lv) else 1)
                 for d, n in enumerate(t.shape))


def batch_entry(global_batch: int, mesh):
    """Spec entry for a leading batch/slot dim: the (combined) data axes
    when they tile the batch, else None."""
    return _fit(mesh, global_batch, data_axes(mesh))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def input_shardings(cfg: ModelConfig, shape: ShapeConfig, specs: dict, mesh) -> dict:
    """Batch-shard every model input over the data axes (dim 0)."""
    b = batch_entry(shape.global_batch, mesh)
    return {k: P(b, *([None] * (v.ndim - 1))) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# MoE strategies
# ---------------------------------------------------------------------------
def moe_serve_strategy(cfg: ModelConfig, mesh) -> str:
    """The resident-expert decode layout for (cfg, mesh), falling back to
    the training-style ``ep`` / ``etp`` tag when no resident layout tiles
    the mesh."""
    dp = data_axes(mesh)
    dp_total = axes_size(mesh, dp)
    m_size = mesh.shape[MODEL_AXIS]
    total = dp_total * m_size
    E, ff = cfg.n_experts, cfg.moe_d_ff
    if E and E % total == 0 and E >= total:
        return "ep2"
    if (E and dp_total > 1 and E % dp_total == 0 and E >= dp_total
            and ff % m_size == 0):
        return "ep_data"
    if ff and ff % total == 0:
        return "etp2"
    return _moe_train_strategy(cfg, mesh)


def _moe_train_strategy(cfg: ModelConfig, mesh) -> str:
    m_size = mesh.shape[MODEL_AXIS]
    if cfg.n_experts % m_size == 0 and cfg.n_experts >= m_size:
        return "ep"
    if cfg.moe_d_ff % m_size == 0:
        return "etp"
    raise ValueError(
        f"no MoE layout tiles model axis {m_size}: n_experts="
        f"{cfg.n_experts}, moe_d_ff={cfg.moe_d_ff} ({cfg.name})")


def _shared_specs(cfg: ModelConfig, mesh) -> dict:
    """Shared-expert MLP: FFN dim tensor-sliced over `model` only (its
    ``w_down`` runs row-parallel over `model`, ``transformer._moe_block``)."""
    if not cfg.n_shared_experts:
        return {}
    ffs = cfg.moe_d_ff * cfg.n_shared_experts
    m_size = mesh.shape[MODEL_AXIS]
    if ffs % m_size != 0 and m_size > 1:
        raise ValueError(f"shared-expert FFN {ffs} does not tile model axis {m_size}")
    m = _fit(mesh, ffs, MODEL_AXIS)
    return {
        "w_up": P(None, m), "w_gate": P(None, m), "w_down": P(m, None),
        "w_up_q": P(None, m), "w_gate_q": P(None, m), "w_down_q": P(m, None),
        "w_up_s": P(m), "w_gate_s": P(m), "w_down_s": P(None),
    }


def moe_param_specs(cfg: ModelConfig, mesh, serve: bool = False) -> dict:
    """Specs for one MoE layer's params: ``{"strategy", "ep_axes", "spec",
    "shared", "gather"}``: the expert stacks' specs (``spec``), the shared
    expert's (``shared``), the axes the experts are placed over
    (``ep_axes``) and, by name, the FSDP dims ``_moe_block`` gathers
    (``gather``, training / prefill only)."""
    dp = data_axes(mesh)
    m = MODEL_AXIS
    all_ax = dp + (m,)
    E, ff, d = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
    strategy = (moe_serve_strategy(cfg, mesh) if serve
                else _moe_train_strategy(cfg, mesh))

    def expert(e=None, din=None, dout=None, s_out=None):
        return {
            "w_up": P(e, din, dout), "w_gate": P(e, din, dout),
            "w_up_q": P(e, din, dout), "w_gate_q": P(e, din, dout),
            "w_up_s": P(e, s_out), "w_gate_s": P(e, s_out),
            "w_down": P(e, dout, din), "w_down_q": P(e, dout, din),
            "w_down_s": P(e, None),
            "router": P(None, None),
        }

    gather: dict[str, int] = {}
    if strategy == "ep2":
        ep_axes = all_ax
        spec = expert(e=_fit(mesh, E, all_ax))
    elif strategy == "ep_data":
        ep_axes = dp
        spec = expert(e=_fit(mesh, E, dp), dout=_fit(mesh, ff, m),
                      s_out=_fit(mesh, ff, m))
    elif strategy == "etp2":
        ep_axes = all_ax
        spec = expert(dout=_fit(mesh, ff, all_ax), s_out=_fit(mesh, ff, all_ax))
    elif strategy == "ep":
        ep_axes = (m,)
        fs = _fit(mesh, d, dp)        # ZeRO-3 store: d_model FSDP-sharded
        ffs = _fit(mesh, ff, dp)
        spec = expert(e=m, din=fs)
        spec["w_down"] = P(m, ffs, None)
        spec["w_down_q"] = P(m, ffs, None)
        spec["w_down_s"] = P(m, None)
        spec["w_up_s"] = spec["w_gate_s"] = P(m, None)
        if fs is not None:
            gather.update({"w_up": 1, "w_gate": 1})
        if ffs is not None:
            gather["w_down"] = 1
    else:                             # etp: all experts local, FFN over model
        ep_axes = (m,)
        spec = expert(dout=_fit(mesh, ff, m), s_out=_fit(mesh, ff, m))
    return {"strategy": strategy, "ep_axes": ep_axes, "spec": spec,
            "shared": _shared_specs(cfg, mesh), "gather": gather}


# ---------------------------------------------------------------------------
# whole-model param shardings
# ---------------------------------------------------------------------------
def _linear_name(path_keys: list[str]) -> str:
    """The linear a leaf belongs to: ``{"wq": ...}`` names itself;
    ``{"lm_head": {"w": ...}}`` is named by its parent dict."""
    leaf = path_keys[-1]
    base = leaf[:-2] if leaf.endswith(("_q", "_s")) else leaf
    if base == "w" and len(path_keys) >= 2:
        return path_keys[-2]
    return base


def _pad(entries, ndim: int):
    """Left-pad a spec with None for stacked leading dims (layer scan)."""
    if len(entries) > ndim:
        return None
    return P(*([None] * (ndim - len(entries)) + list(entries)))


def _walk(node, path_keys, leaf_fn):
    if isinstance(node, dict):
        return {k: _walk(v, path_keys + [k], leaf_fn) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_walk(v, path_keys, leaf_fn) for v in node)
    return leaf_fn(path_keys, node)


def param_shardings(cfg: ModelConfig, params_abs: Any, mesh, serve: bool = False):
    """The spec tree matching ``params_abs`` (float or quantized; any tree
    of dicts and lists whose leaves have ``ndim`` and ``shape``)."""
    dp = data_axes(mesh)
    m = MODEL_AXIS
    moe = moe_param_specs(cfg, mesh, serve=serve) if cfg.n_experts else None

    def spec_for(path_keys: list[str], x) -> tuple:
        leaf = path_keys[-1]
        if moe is not None and "moe" in path_keys:
            table = moe["shared"] if "shared" in path_keys else moe["spec"]
            got = table.get(leaf)
            if got is not None:
                padded = _pad(tuple(got), x.ndim)
                if padded is not None:
                    return padded
            return P()
        name = _linear_name(path_keys)
        scale = leaf.endswith("_s")
        if name == "embed" and x.ndim >= 2:
            return _pad((_fit(mesh, x.shape[-2], m),
                         _fit(mesh, x.shape[-1], dp)), x.ndim)
        if name in ("lm_head", "mtp_proj") and not scale and x.ndim >= 2:
            return _pad((_fit(mesh, x.shape[-2], dp),
                         _fit(mesh, x.shape[-1], m)), x.ndim)
        if name in _COL_PARALLEL:
            if scale:
                return _pad((_fit(mesh, x.shape[-1], m),), x.ndim)
            if x.ndim >= 2:
                return _pad((_fit(mesh, x.shape[-2], dp),
                             _fit(mesh, x.shape[-1], m)), x.ndim)
        if name in _ROW_PARALLEL:
            if scale:
                return _pad((_fit(mesh, x.shape[-1], dp),), x.ndim)
            if x.ndim >= 2:
                return _pad((_fit(mesh, x.shape[-2], m),
                             _fit(mesh, x.shape[-1], dp)), x.ndim)
        return P()                       # norms, router, SSM controller ops

    return _walk(params_abs, [], spec_for)


# ---------------------------------------------------------------------------
# decode state and serve-step I/O
# ---------------------------------------------------------------------------
def prefill_carry_shardings(cfg: ModelConfig, carry_abs: Any, mesh):
    """Chunked-prefill carry (B=1 float K/V + cursor): nothing shards over
    the data axes, attention heads (dim 3 of the reference's 5-dim
    ``[n_p, 1, S_buf, H, D]`` buffers) shard over ``model`` when they tile
    it, as the slot pool's do.  ``pos`` and low-rank leaves replicate."""

    def leaf(path_keys, x):
        if "pos" in path_keys or x.ndim < 5:
            return replicated(mesh)
        entries = [None] * x.ndim
        entries[3] = _fit(mesh, x.shape[3], MODEL_AXIS)
        return P(*entries)

    return _walk(carry_abs, [], leaf)


def serve_step_shardings(n_slots: int, mesh) -> dict:
    """Decode-lane I/O: ``tokens`` [B], ``block`` [B, m] and ``logits``
    [B, V], the slot axis over the data axes."""
    b = batch_entry(n_slots, mesh)
    return {"tokens": P(b), "block": P(b, None), "logits": P(b, None)}


def verify_shardings(n_slots: int, mesh) -> dict:
    """Verify-step I/O: [B, T] draft tokens, [B, T, V] logits, [B, T, d]
    hidden carry, the slot axis over the data axes."""
    b = batch_entry(n_slots, mesh)
    return {"tokens": P(b, None), "logits": P(b, None, None),
            "hidden": P(b, None, None)}


def tree_verify_shardings(n_slots: int, mesh) -> dict:
    """Tree-verify extras: depth / anc [B, T] (slot axis over the data
    axes) and the replicated tree-commit operands."""
    b = batch_entry(n_slots, mesh)
    return {"window": P(b, None), "commit": replicated(mesh)}


def prefix_gather_shardings(mesh) -> dict:
    """Prefix-cache admission scalars (slot ids, matched row count),
    replicated.  The port has no partitioner to pin them: a cached prefix
    whose slots' data owners differ moves point to point
    (``transformer.copy_slot_prefix``), the cross-shard move the reference's
    partitioner lowers."""
    r = replicated(mesh)
    return {"slot": r, "rows": r}


def swap_row_shardings(mesh) -> dict:
    """Tiered-pool swap I/O (the slot id and the batch=1 row tree),
    replicated: the port renders it as ``transformer.gather_slot_row`` (a
    swapped row is whole on every rank's host)."""
    r = replicated(mesh)
    return {"slot": r, "row": r}


def decode_state_shardings(cfg: ModelConfig, shape: ShapeConfig, state_abs: Any, mesh):
    """Slot-pool decode state: the slot axis (dim 1 of every cache leaf of
    the reference's ``[n_p, B, ...]`` stacks) over the data axes, and the
    KV heads of a 5-dim ``[n_p, B, S, H_kv, D]`` leaf over ``model`` when
    they tile it.  ``pos`` and other per-slot scalars replicate.  As in the
    reference, a stacked SSM ``h`` ``[n_p, B, H, P, N]`` is 5-dim too and
    gets its dim 3 (the head dim ``P``) split; the port's pool places an
    SSM layer's ``h`` and ``conv_x`` by heads instead
    (``transformer.layer_cuts``)."""
    b = batch_entry(shape.global_batch, mesh)

    def leaf(path_keys, x):
        if "pos" in path_keys or x.ndim < 2:
            return replicated(mesh)
        entries = [None] * x.ndim
        if x.shape[1] == shape.global_batch:
            entries[1] = b
        if x.ndim == 5:
            entries[3] = _fit(mesh, x.shape[3], MODEL_AXIS)
        return P(*entries)

    return _walk(state_abs, [], leaf)


# ---------------------------------------------------------------------------
# blocks of whole tensors
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def live(spec: tuple, mesh) -> tuple:
    """``spec`` with the axes of size 1 dropped (they split nothing), each
    entry a tuple of axes: two specs that give every rank the same block
    are equal after this."""
    return tuple(tuple(a for a in _entry_axes(e) if mesh.shape[a] > 1) for e in spec)


def block(n: int, mesh, axes) -> slice:
    """This rank's range of a dim of ``n`` split over ``axes``."""
    axes = tuple(axes)
    if not axes:
        return slice(0, n)
    size = axes_size(mesh, axes)
    if n % size:
        raise ValueError(f"dim {n} does not tile axes {axes} of size {size}")
    i = mesh.index(axes)
    return slice(i * (n // size), (i + 1) * (n // size))


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    contiguous copy where anything is cut, else ``t`` itself)."""
    sl = [block(t.shape[d], mesh, axes) for d, axes in enumerate(live(spec, mesh))]
    if all(s == slice(0, t.shape[d]) for d, s in enumerate(sl)):
        return t
    return t[tuple(sl)].contiguous()


def unshard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``t`` under ``spec``
    (all-gathers over each split dim's axes)."""
    return reshard(t, spec, (), mesh)


def reshard(t: torch.Tensor, spec_from: tuple, spec_to: tuple, mesh) -> torch.Tensor:
    """This rank's block under ``spec_to`` from its block ``t`` under
    ``spec_from``: each dim whose split differs is gathered over its old
    axes and cut by its new ones (a dim split alike stays as it is)."""
    from repro_torch.dist import collectives as C
    src, dst = live(spec_from, mesh), live(spec_to, mesh)
    nd = t.dim()
    src = src + ((),) * (nd - len(src))
    dst = dst + ((),) * (nd - len(dst))
    for d in range(nd):
        if src[d] == dst[d]:
            continue
        if src[d]:
            t = C.all_gather(t, mesh.group(src[d]), dim=d)
        if dst[d]:
            t = t.narrow(d, block(t.shape[d], mesh, dst[d]).start,
                         t.shape[d] // axes_size(mesh, dst[d])).contiguous()
    return t


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`shard` over matching trees of tensors and specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return shard(tree, specs, mesh)
    return tree
